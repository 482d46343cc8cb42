"""gf_swar's launch choices: the compile-time RS(10,4) parity form and
the column words a thread takes (W).

The kernels hold the RS(10,4) parity as constants (``rs10x4_coef`` in
``csrc/gf_swar_column.cuh``, the column algebra gf_swar and gf_swar_u8
share); the wrapper marks a coefficient whose matrix is that
parity and sends it there, every other matrix through the run-time
struct. The table must be the matrix both packages build, and the mark
must fall on that matrix alone, or an encode would write wrong parity.
W is chosen per launch from its size and the card's SM count. The CUDA
kernels themselves are held against the plain version on the card by
chip_smoke.py, at every W and in both forms; here the plain version is
held against the reference's Pallas kernel on the tail widths those
cases use.
"""

import itertools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops.pallas import gf_kernel  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import gf_swar  # noqa: E402

SOURCE = os.path.join(os.path.dirname(gf_swar.__file__), "csrc",
                      "gf_swar_column.cuh")
# the H100 SXM's streaming multiprocessors
H100_SMS = 132
MIB = 1 << 20


def source_table() -> np.ndarray:
    """The ``kRs10x4Parity[4][10]`` initialiser of the kernels' shared
    column header."""
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"kRs10x4Parity\[kRsOut\]\[kRsIn\]\s*=\s*\{(.*?)\};",
                     text, re.S)
    assert body, "no kRs10x4Parity table in gf_swar_column.cuh"
    rows = re.findall(r"\{([^{}]*)\}", body.group(1))
    return np.array([[int(v, 0) for v in r.split(",") if v.strip()]
                     for r in rows], dtype=np.uint8)


def test_source_table_is_the_parity_of_both_packages():
    table = source_table()
    assert table.shape == (4, 10)
    np.testing.assert_array_equal(table, ref_gf256.parity_matrix(10, 4))
    np.testing.assert_array_equal(table, gf256.parity_matrix(10, 4))


@pytest.mark.parametrize("matrix,marked", [
    (ref_gf256.parity_matrix(10, 4), True),
    (gf256.parity_matrix(10, 4), True),
    (ref_gf256.parity_matrix(12, 4), False),
    (ref_gf256.parity_matrix(6, 3), False),
    (ref_gf256.parity_matrix(20, 4), False),
    (ref_gf256.parity_matrix(10, 4)[:3], False),
    (np.random.default_rng(5).integers(0, 256, (4, 10), dtype=np.uint8),
     False),
], ids=["rs10x4-ref", "rs10x4-port", "rs12x4", "rs6x3", "rs20x4",
        "rs10x4-3-rows", "random"])
def test_mark_falls_on_the_rs10x4_parity_alone(matrix, marked):
    assert gf_swar.coeff_from_reference(matrix).rs10x4 is marked


def test_one_changed_byte_loses_the_mark():
    m = ref_gf256.parity_matrix(10, 4).copy()
    m[2, 7] ^= 1
    assert not gf_swar.coeff_from_reference(m).rs10x4


def test_reconstruction_matrices_take_the_runtime_form():
    """Of the 1,470 reconstruction matrices of 1-4 losses of RS(10,4),
    only the one that rebuilds all four parity shards from the ten data
    shards is the parity matrix itself, and only it is marked."""
    parity = ref_gf256.parity_matrix(10, 4)
    marked = []
    n = 0
    for lost_count in range(1, 5):
        for lost in itertools.combinations(range(14), lost_count):
            present = [i for i in range(14) if i not in lost]
            r, _ = ref_gf256.reconstruction_matrix(10, 4, present)
            n += 1
            coeff = gf_swar.coeff_from_reference(r)
            if coeff.rs10x4:
                marked.append(lost)
                np.testing.assert_array_equal(r, parity)
    assert n == 1470
    assert marked == [(10, 11, 12, 13)]


def test_launch_plan_form_follows_the_mark():
    parity = gf_swar.coeff_from_reference(gf256.parity_matrix(10, 4))
    rec = gf_swar.coeff_from_reference(gf256.reconstruction_matrix(
        10, 4, [1, 2, 3, 4, 6, 7, 8, 9, 10, 12])[0])
    assert gf_swar.launch_plan(parity, MIB // 16, 1, H100_SMS) == (
        1, gf_swar.FORM_RS10X4)
    assert gf_swar.launch_plan(rec, 8 * MIB // 16, 1, H100_SMS) == (
        2, gf_swar.FORM_RUNTIME)


@pytest.mark.parametrize("label,n_bytes,threads_over,o,width", [
    # a rebuild window of 1-4 lost shards: [10, 8 MiB], run-time form
    ("rebuild 4 lost", 8 * MIB, 1, 4, 2),
    ("rebuild 1 lost", 8 * MIB, 1, 1, 2),
    # a small volume's rebuild window: [10, 1 MiB], too few words for W = 2
    ("rebuild 1 MiB window", MIB, 1, 4, 1),
    # the run-time form on a batch encode's lane-packed chunk, [10, 4 MiB]
    ("4 MiB chunk", 4 * MIB, 1, 4, 2),
    # phase 7's slab and 8-volume batch in the run-time form
    ("slab [10, 64 MiB]", 64 * MIB, 1, 4, 2),
    ("batch [8, 10, 8 MiB]", 8 * MIB, 8, 4, 2),
    ("fused volumes [8, 10, 256 KiB]", 256 * 1024, 1, 4, 1),
    # tails: column words that W = 2 does not divide
    ("tail n16 % 2 == 1", 8 * MIB + 16, 1, 4, 2),
    ("odd 1 MiB + 5 words", MIB + 80, 1, 4, 1),
    # accumulators that would not fit twice
    ("RS(20,5) slab", 64 * MIB, 1, 5, 1),
    ("RS(20,8) slab", 64 * MIB, 1, 8, 1),
    ("16 outputs", 64 * MIB, 1, 16, 1),
])
def test_choose_width(label, n_bytes, threads_over, o, width):
    n16 = n_bytes // gf_swar.QUANTUM
    assert gf_swar.choose_width(n16, threads_over, o, H100_SMS) == width
    assert width <= gf_swar.max_width(o)
    # past the chosen W, the launch would leave SMs short of threads or
    # the accumulators would not fit
    wider = [w for w in gf_swar.WIDTHS if w > width]
    for w in wider:
        assert (w > gf_swar.max_width(o)
                or threads_over * -(-n16 // w)
                < H100_SMS * gf_swar.MIN_THREADS_PER_SM)


def test_max_width_keeps_accumulators_to_eight_words():
    """O x W uint4 accumulators: at most 8 a thread (32 registers) past
    W = 1; the compile-time form has W = 1 alone."""
    for o in range(1, gf_swar.MAX_OUT + 1):
        w = gf_swar.max_width(o)
        assert w in gf_swar.WIDTHS
        assert w == max(x for x in gf_swar.WIDTHS if x == 1 or o * x <= 8)
    assert gf_swar.max_width(4, gf_swar.FORM_RS10X4) == 1


@pytest.mark.parametrize("n_bytes,threads_over", [
    (MIB, 1), (4 * MIB, 1), (8 * MIB, 8), (64 * MIB, 1), (64 * MIB + 16, 1)])
def test_compile_time_form_takes_one_word_a_thread(n_bytes, threads_over):
    """The encode row, the batch encode's chunk, the word forms' batch and
    the slab all launch the parity at W = 1."""
    parity = gf_swar.coeff_from_reference(gf256.parity_matrix(10, 4))
    assert gf_swar.launch_plan(parity, n_bytes // gf_swar.QUANTUM,
                               threads_over, H100_SMS) == (
        1, gf_swar.FORM_RS10X4)


@pytest.mark.parametrize("which,n16", [
    ("parity", 1), ("parity", 4 * 64 + 1), ("rebuild", 3),
    ("rebuild", 2 * 64 + 1)])
def test_plain_matches_pallas_on_tail_widths(which, n16):
    """The plain version, which chip_smoke holds each W and form to on
    the card, equals the reference's Pallas swar kernel (interpret mode)
    on column-word counts no W divides."""
    if which == "parity":
        coeff = ref_gf256.parity_matrix(10, 4)
    else:
        present = [i for i in range(14) if i not in (0, 5, 11, 13)]
        coeff = ref_gf256.reconstruction_matrix(10, 4, present)[0]
    rng = np.random.default_rng(n16)
    data = rng.integers(0, 256, (10, 16 * n16), dtype=np.uint8)
    got = gf_swar.gf_matmul(gf_swar.coeff_from_reference(coeff),
                            torch.from_numpy(data)).numpy()
    want = np.asarray(gf_kernel.gf_matmul_pallas(coeff, data, method="swar",
                                                 tile_n=2048))
    np.testing.assert_array_equal(got, want)
