"""gf_swar_u8's launch choices and its plain version against the reference.

The u8 route's kernel (``csrc/gf_swar_u8.cu``) takes gf_swar's two
coefficient forms and W column words a thread behind its strided, ragged
u8 loads; the wrapper takes (W, form) from ``gf_swar.launch_plan`` over
the row's 16-byte column words, rounded up. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py, in each
form at each W; here the plan, the mark, the launcher's C signature and
the library's width check are held to what the kernel instantiates, and
the plain version to the reference's ``_gf_matmul_swar_u8_device`` (the
Pallas ``_swar_u8_kernel`` in interpret mode) on tail widths and strided
rows. Tolerance 0: GF(2^8) arithmetic is exact.
"""

import ctypes
import os
import re
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops.pallas import gf_kernel as ref_kernel  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import (  # noqa: E402
    build,
    gf_swar,
    gf_swar_u8,
)

# the H100 SXM's streaming multiprocessors
H100_SMS = 132
MIB = 1 << 20
RT, RS = gf_swar.FORM_RUNTIME, gf_swar.FORM_RS10X4
# words a launch needs before W = 2 leaves each SM its 512 threads
W2_WORDS = 2 * H100_SMS * gf_swar.MIN_THREADS_PER_SM


def rec(lost):
    present = [i for i in range(14) if i not in lost]
    return ref_gf256.reconstruction_matrix(10, 4, present)[0]


def meta(*shape):
    """A tensor of ``shape`` that holds no bytes: the plan reads shapes
    only."""
    return torch.empty(shape, dtype=torch.uint8, device="meta")


@pytest.mark.parametrize("label,matrix,shape,plan", [
    # the encode row and the device-resident slab: compile-time, W = 1
    ("parity [10, 1 MiB]", ref_gf256.parity_matrix(10, 4), (10, MIB),
     (1, RS)),
    ("parity [10, 64 MiB]", ref_gf256.parity_matrix(10, 4), (10, 64 * MIB),
     (1, RS)),
    ("parity batch [8, 10, 64 MiB]", ref_gf256.parity_matrix(10, 4),
     (8, 10, 64 * MIB), (1, RS)),
    # the rebuild's window and slab: run-time, W = 2
    ("rebuild [10, 8 MiB]", rec((0, 5, 11, 13)), (10, 8 * MIB), (2, RT)),
    ("rebuild [10, 64 MiB]", rec((0, 5, 11, 13)), (10, 64 * MIB), (2, RT)),
    # a small rebuild window has too few words for W = 2 ...
    ("rebuild [10, 1 MiB + 3]", rec((3,)), (10, MIB + 3), (1, RT)),
    # ... unless a batch gives the launch its threads
    ("rebuild batch [4, 10, 1 MiB]", rec((3,)), (4, 10, MIB), (2, RT)),
    # a ragged width counts its partial last word: one byte past
    # W2_WORDS - 2 whole words reaches W = 2
    ("rebuild ragged, words rounded up", rec((3,)),
     (10, 16 * (W2_WORDS - 2) + 1), (2, RT)),
    ("rebuild just short of W = 2", rec((3,)), (10, 16 * (W2_WORDS - 2)),
     (1, RT)),
    # other RS parities take the run-time form; five outputs stay at W = 1
    ("RS(12,4) parity [12, 64 MiB]", ref_gf256.parity_matrix(12, 4),
     (12, 64 * MIB), (2, RT)),
    ("RS(20,5) parity [20, 64 MiB]", ref_gf256.parity_matrix(20, 5),
     (20, 64 * MIB), (1, RT)),
    ("RS(20,5) parity batch [8, 20, 8 MiB]", ref_gf256.parity_matrix(20, 5),
     (8, 20, 8 * MIB), (1, RT)),
])
def test_launch_plan(label, matrix, shape, plan):
    coeff = gf_swar.coeff_from_reference(matrix)
    assert gf_swar_u8.launch_plan(coeff, meta(*shape), H100_SMS) == plan
    width, form = plan
    assert 1 <= width <= gf_swar.max_width(matrix.shape[0], form)


def test_plan_is_gf_swars_over_rounded_up_words():
    """The u8 route plans as gf_swar does for the padded width it would
    launch: ceil(N / 16) words in each batch slice."""
    coeff = gf_swar.coeff_from_reference(rec((0, 13)))
    for lead, n in [((), 1), ((), 15), ((), 16 * W2_WORDS - 15),
                    ((3,), 4097), ((2, 2), 8 * MIB + 5)]:
        batch = int(np.prod(lead))
        assert gf_swar_u8.launch_plan(coeff, meta(*lead, 10, n),
                                      H100_SMS) == gf_swar.launch_plan(
            coeff, -(-n // 16), batch, H100_SMS)


@pytest.mark.parametrize("matrix,form", [
    (ref_gf256.parity_matrix(10, 4), RS),
    (gf256.parity_matrix(10, 4), RS),
    # rebuilding all four parity shards from the data is the parity itself
    (rec((10, 11, 12, 13)), RS),
    (rec((0, 5, 11, 13)), RT),
    (rec((3,)), RT),
    (ref_gf256.parity_matrix(12, 4), RT),
    (ref_gf256.parity_matrix(6, 3), RT),
    (ref_gf256.parity_matrix(20, 4), RT),
    (np.random.default_rng(6).integers(0, 256, (4, 10), dtype=np.uint8), RT),
], ids=["rs10x4-ref", "rs10x4-port", "rebuild-parity", "rebuild-4",
        "rebuild-1", "rs12x4", "rs6x3", "rs20x4", "random"])
def test_mark_falls_on_the_parity_alone(matrix, form):
    coeff = gf_swar.coeff_from_reference(matrix)
    k = matrix.shape[1]
    assert gf_swar_u8.launch_plan(coeff, meta(k, 64 * MIB),
                                  H100_SMS)[1] == form


def test_cpu_tensors_never_launch():
    parity = ref_gf256.parity_matrix(10, 4)
    x = torch.zeros((10, 4096), dtype=torch.uint8)
    before = (gf_swar_u8.LAUNCHES.value, gf_swar_u8.RS10X4_LAUNCHES.value)
    for matrix in (parity, rec((3,))):
        out = gf_swar_u8.gf_matmul(matrix, x)
        assert out.device.type == "cpu" and tuple(out.shape) == (
            matrix.shape[0], 4096)
    assert (gf_swar_u8.LAUNCHES.value,
            gf_swar_u8.RS10X4_LAUNCHES.value) == before


def test_other_devices_raise():
    with pytest.raises(ValueError):
        gf_swar_u8.gf_matmul(ref_gf256.parity_matrix(10, 4), meta(10, 64))


def _c_signature(source: str, fn: str) -> list[str]:
    """The parameter types of C function ``fn`` in ``source``."""
    m = re.search(rf"int {fn}\((.*?)\)\s*\{{", source, re.S)
    assert m, f"no {fn} in the source"
    return [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0]
            + ("*" if "*" in p.rsplit(" ", 1)[-1] else "")
            for p in m.group(1).split(",")]


def test_launcher_signature_matches_the_wrapper():
    """The ctypes argument list the wrapper declares is the C launcher's,
    type by type: the extra (width, form) after the row width."""
    with open(os.path.join(build.CSRC, "gf_swar_u8.cu")) as f:
        params = _c_signature(f.read(), "gf_swar_u8_launch")
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = [ctype[p] for p in params]
    # the coefficient struct is passed as bytes
    want[params.index("const void*", 1)] = ctypes.c_char_p
    assert gf_swar_u8.KERNEL._argtypes == want
    assert len(params) == 15


def _fake_library(max_width):
    def fn(*_):
        return 0

    def coeff_bytes():
        return gf_swar.MAX_IN * 8 * 2 + gf_swar.MAX_IN

    return types.SimpleNamespace(
        gf_swar_u8_launch=fn, gf_swar_u8_error_string=fn,
        gf_swar_u8_coeff_bytes=coeff_bytes, gf_swar_u8_max_width=max_width)


def test_library_widths_must_match(monkeypatch):
    """The library's max_width must give the wrapper's for every output
    count and form, or loading it raises."""
    monkeypatch.setattr(build, "load", lambda name: _fake_library(
        gf_swar.max_width))
    kernel = gf_swar.RowsKernel("gf_swar_u8", (ctypes.c_int, ctypes.c_int),
                                forms=True)
    assert kernel.library() is not None

    monkeypatch.setattr(build, "load", lambda name: _fake_library(
        lambda o, form: gf_swar.max_width(o, form) + (o == 5)))
    kernel = gf_swar.RowsKernel("gf_swar_u8", (ctypes.c_int, ctypes.c_int),
                                forms=True)
    with pytest.raises(RuntimeError, match="widths"):
        kernel.library()


def reference(coeff, data):
    """The reference's device-u8 swar route, ``_gf_matmul_swar_u8_device``,
    in interpret mode on the CPU backend."""
    return np.asarray(ref_kernel.gf_matmul_pallas(
        coeff, jax.device_put(data), method="swar"))


@pytest.mark.parametrize("which,lead,k_rows,n", [
    # a partial last word and a word count no W divides
    ("parity", (), 10, 16 * 33 + 5),
    # rows 0-9 of a [14, N] tensor, a ragged width
    ("rebuild", (), 14, 1000 + 3),
    # a batch of ragged rows
    ("parity", (2,), 10, 517),
])
def test_plain_matches_pallas(which, lead, k_rows, n):
    coeff = (ref_gf256.parity_matrix(10, 4) if which == "parity"
             else rec((0, 5, 11, 13)))
    rng = np.random.default_rng(n)
    full = rng.integers(0, 256, (*lead, k_rows, n), dtype=np.uint8)
    rows = torch.from_numpy(full)[..., :10, :]  # a view: strided when 14
    got = gf_swar_u8.gf_matmul(coeff, rows).numpy()
    want = reference(coeff, np.ascontiguousarray(full[..., :10, :]))
    np.testing.assert_array_equal(got, want)
