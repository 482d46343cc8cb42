"""The port's ``vpu`` route (``gf_vpu``) held against the JAX package's
``gf_matmul_pallas(method="vpu")`` run in interpret mode on the same
inputs, for host numpy and device (jax on the CPU) u8 input.

On the CPU the route runs the kernel's plain version; the CUDA case runs
the kernel against it and skips here. The kernel's own algebra (split
product tables looked up by byte permutes) is held to the same bytes
through its step-by-step model, ``gf_vpu.gf_matmul_tables``. Tolerance
0: GF(2^8) arithmetic is exact.
"""

import re
import zlib

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
    gf_kernel,
    gf_swar,
    gf_vpu,
)

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")
LOSSES = [(3,), (0, 13), (0, 5, 11), (0, 5, 11, 13)]


def rng_for(*params):
    return np.random.default_rng(zlib.crc32(repr(params).encode()))


def rec_matrix(lost, k=10, m=4):
    present = tuple(i for i in range(k + m) if i not in lost)
    return ref_gf256.reconstruction_matrix(k, m, present)[0]


def check_route(coeff, data, kind):
    """The port's vpu route against the reference's on ``data``: host
    numpy in, numpy out; a u8 tensor in, a u8 tensor out."""
    if kind == "host":
        want = np.asarray(ref_kernel.gf_matmul_pallas(
            coeff, data, method="vpu", interpret=True))
        got = gf_kernel.gf_matmul_fused(coeff, data, method="vpu",
                                        device="cpu")
        assert isinstance(got, np.ndarray)
    else:
        want = np.asarray(ref_kernel.gf_matmul_pallas(
            coeff, jax.device_put(data), method="vpu", interpret=True))
        got = gf_kernel.gf_matmul_fused(coeff, torch.from_numpy(data),
                                        method="vpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        got = got.numpy()
    o = coeff.shape[0]
    assert got.shape == data.shape[:-2] + (o, data.shape[-1])
    np.testing.assert_array_equal(got, want)


KINDS = ["host", "device"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1000, 8192 + 17])
def test_parity_10_4(kind, n):
    data = rng_for("parity", kind, n).integers(0, 256, (10, n),
                                               dtype=np.uint8)
    check_route(ref_gf256.parity_matrix(10, 4), data, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lost", LOSSES)
def test_reconstruction(kind, lost):
    data = rng_for("lost", kind, lost).integers(0, 256, (10, 1000),
                                                dtype=np.uint8)
    check_route(rec_matrix(lost), data, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,m", [(6, 3), (12, 4), (20, 4)])
def test_rs_shapes(kind, k, m):
    data = rng_for("rs", kind, k, m).integers(0, 256, (k, 1000),
                                              dtype=np.uint8)
    check_route(ref_gf256.parity_matrix(k, m), data, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1000, 8192 + 17])
def test_batch(kind, n):
    data = rng_for("batch", kind, n).integers(0, 256, (2, 10, n),
                                              dtype=np.uint8)
    check_route(ref_gf256.parity_matrix(10, 4), data, kind)


@pytest.mark.parametrize("o,k", [(1, 1), (4, 10), (7, 13), (16, 64)])
def test_plain_version_is_the_gf_product(o, k):
    """The plain version's one-byte-per-lane algebra equals the host GF
    product for any matrix, zero columns and every block width of the
    kernel (4, 8 and 16 bytes by output count) included."""
    rng = rng_for("plain", o, k)
    coeff = rng.integers(0, 256, (o, k), dtype=np.uint8)
    coeff[:, 0] = 0
    data = rng.integers(0, 256, (k, 777), dtype=np.uint8)
    want = ref_gf256.gf_matmul_cpu(coeff, data)
    for c in (coeff, gf_swar.coeff_from_reference(coeff)):
        got = gf_vpu.gf_matmul_plain(c, torch.from_numpy(data))
        np.testing.assert_array_equal(got.numpy(), want)


def test_strided_rows_and_errors():
    shards = torch.from_numpy(
        rng_for("strided").integers(0, 256, (14, 4099), dtype=np.uint8))
    coeff = ref_gf256.parity_matrix(10, 4)
    got = gf_vpu.gf_matmul(coeff, shards[:10])
    np.testing.assert_array_equal(
        got.numpy(), ref_gf256.gf_matmul_cpu(coeff, shards[:10].numpy()))
    with pytest.raises(ValueError):
        gf_vpu.gf_matmul(coeff, shards[:9])
    with pytest.raises(ValueError):
        gf_vpu.gf_matmul(coeff, shards[:10].to(torch.int32))


def test_cpu_tensors_never_launch():
    before = gf_vpu.LAUNCHES.value
    gf_vpu.gf_matmul(ref_gf256.parity_matrix(10, 4),
                     torch.zeros((10, 64), dtype=torch.uint8))
    assert gf_vpu.LAUNCHES.value == before


def test_host_input_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        gf_kernel.gf_matmul_fused(ref_gf256.parity_matrix(10, 4),
                                  np.zeros((10, 64), np.uint8), method="vpu")


def test_table_model_is_the_product_table():
    """The kernel's tables and byte-permute lookups give c·x for all 256
    coefficients and all 256 bytes: the port's GF(2^8) product table."""
    matrix = np.arange(256, dtype=np.uint8).reshape(256, 1)
    data = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    got = gf_vpu.gf_matmul_tables(matrix, data)
    np.testing.assert_array_equal(got.numpy(), gf256.mul_table())


def test_selectors_never_replicate_a_sign():
    """Bit 3 of every selector nibble is clear for every pair of bytes,
    so PRMT always picks a table byte, and each nibble indexes its
    piece's table within its length (8, 8 and 4 entries)."""
    a = torch.arange(256, dtype=torch.int64).repeat_interleave(256)
    b = torch.arange(256, dtype=torch.int64).repeat(256)
    spread = a | a << 8 | a << 16 | a << 24, b | b << 8 | b << 16 | b << 24
    sel = gf_vpu.pair_selectors(*spread)
    for p, top in enumerate((7, 7, 3, 7, 7, 3)):
        for j in range(8 if p < 3 else 4):
            nib = (sel[p] >> (4 * j)) & 0xF
            assert int(nib.max()) == top, (p, j)
    assert torch.equal(sel[0] & 0xFFFF, (a & 7) | (b & 7) << 4
                       | (a & 7) << 8 | (b & 7) << 12)


def _random_16x64():
    coeff = rng_for("tables", 16, 64).integers(0, 256, (16, 64),
                                               dtype=np.uint8)
    coeff[0, :3] = (0, 1, 255)
    coeff[5, 7] = 0
    coeff[:, 9] = 0
    return coeff


TABLE_CASES = {
    "parity(10,4)": (lambda: ref_gf256.parity_matrix(10, 4), (10, 1000)),
    **{f"lost={lost}": (lambda lost=lost: rec_matrix(lost), (10, 999))
       for lost in LOSSES},
    "parity(6,3)": (lambda: ref_gf256.parity_matrix(6, 3), (6, 1001)),
    "parity(12,4)": (lambda: ref_gf256.parity_matrix(12, 4), (12, 1000)),
    "parity(20,4)": (lambda: ref_gf256.parity_matrix(20, 4), (20, 777)),
    "random 16x64": (_random_16x64, (64, 203)),
    "parity(10,4) width 1": (lambda: ref_gf256.parity_matrix(10, 4),
                             (10, 1)),
    "parity(10,4) width 13": (lambda: ref_gf256.parity_matrix(10, 4),
                              (10, 13)),
    "parity(10,4) batch 3": (lambda: ref_gf256.parity_matrix(10, 4),
                             (3, 10, 8192 + 17)),
    "lost=(0, 5, 11, 13) batch 2": (lambda: rec_matrix((0, 5, 11, 13)),
                                    (2, 10, 4095)),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_table_model_matches_reference(case):
    """The kernel's table algebra, the plain version and the reference's
    ``_vpu_kernel`` (interpret mode) give the same bytes."""
    make, shape = TABLE_CASES[case]
    coeff = make()
    data = rng_for("tables", case).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(ref_kernel.gf_matmul_pallas(
        coeff, data, method="vpu", interpret=True))
    x = torch.from_numpy(data)
    for c in (coeff, gf_swar.coeff_from_reference(coeff)):
        np.testing.assert_array_equal(
            gf_vpu.gf_matmul_tables(c, x).numpy(), want)
    np.testing.assert_array_equal(gf_vpu.gf_matmul_plain(coeff, x).numpy(),
                                  want)


def test_chip_smoke_bound_is_the_function_and_lookups_counted():
    """chip_smoke's gf_vpu bound counts bytes read and written once
    (0.2805 ms at [10, 64 MiB] on the H100's 3.35 TB/s), the old count
    (the first design's doublings and XORs a byte) stays beside it, and
    its SASS check counts register-selector PRMTs, not the immediate
    ones that put the interleaved columns back."""
    import chip_smoke

    n = 64 << 20
    assert chip_smoke.vpu_work(4, 10, n) == (14 * n, 0, 0)
    ms, by = chip_smoke.bound(*chip_smoke.vpu_work(4, 10, n))
    assert by == "bytes" and ms == pytest.approx(0.2805, abs=1e-4)
    before = {name: chip_smoke.bound(*chip_smoke.vpu_work_before(m, n))
              for name, m in (("parity", ref_gf256.parity_matrix(10, 4)),
                              ("rebuild", rec_matrix((0, 5, 11, 13))))}
    assert before["parity"][0] == pytest.approx(1.1073, abs=1e-4)
    assert before["rebuild"][0] == pytest.approx(1.1555, abs=1e-4)
    listing = ("/*0a10*/ PRMT R4, R5, R6, R7 ;\n"
               "/*0a20*/ PRMT R8, R9, R10, RZ ;\n"
               "/*0a30*/ PRMT R11, R4, 0x6420, R8 ;\n")
    assert len(re.findall(chip_smoke.VPU_LOOKUP, listing)) == 2


@needs_card
def test_kernel_on_card_matches_plain():
    dev = torch.device("cuda")
    for o, k in ((4, 10), (6, 8), (16, 20)):
        coeff = rng_for("card", o, k).integers(0, 256, (o, k),
                                               dtype=np.uint8)
        for shape in ((k, 1), (k, 4095), (2, k, 65536 + 3)):
            x = torch.from_numpy(rng_for("card", shape).integers(
                0, 256, shape, dtype=np.uint8))
            before = gf_vpu.LAUNCHES.value
            got = gf_vpu.gf_matmul(coeff, x.to(dev))
            assert gf_vpu.LAUNCHES.value == before + 1
            assert torch.equal(got.cpu(), gf_vpu.gf_matmul_plain(coeff, x))
