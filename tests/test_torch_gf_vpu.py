"""The port's ``vpu`` route (``gf_vpu``) held against the JAX package's
``gf_matmul_pallas(method="vpu")`` run in interpret mode on the same
inputs, for host numpy and device (jax on the CPU) u8 input.

On the CPU the route runs the kernel's plain version; the CUDA case runs
the kernel against it and skips here. Tolerance 0: GF(2^8) arithmetic is
exact.
"""

import zlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops.pallas import gf_kernel as ref_kernel  # noqa: E402
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
