"""The port's bit-plane GF(2^8) product (plain PyTorch) equals the JAX
package's ``ops/gf_matmul.py`` on the CPU, for the three compute dtypes,
ragged N and batched input. Tolerance 0: GF(2^8) arithmetic is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops import gf_matmul as ref_gf_matmul  # noqa: E402
from seaweedfs_tpu_torch.ops import bitmatrix, gf_matmul  # noqa: E402

DTYPES = ["bfloat16", "float32", "int8"]


def rng_for(*params):
    import zlib

    return np.random.default_rng(zlib.crc32(repr(params).encode()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,m,n", [(10, 4, 1000), (6, 3, 1), (20, 4, 333),
                                   (12, 4, 4096)])
def test_gf_matmul_matches_reference(dtype, k, m, n):
    coeff = ref_gf256.parity_matrix(k, m)
    data = rng_for(k, m, n).integers(0, 256, (k, n), dtype=np.uint8)
    got = gf_matmul.gf_matmul(coeff, torch.from_numpy(data), dtype)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = np.asarray(ref_gf_matmul.gf_matmul(coeff, data, dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_gf256.gf_matmul_cpu(coeff, data))


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_matches_reference(dtype):
    coeff = ref_gf256.parity_matrix(10, 4)
    data = rng_for("batch", dtype).integers(0, 256, (2, 3, 10, 129),
                                            dtype=np.uint8)
    got = gf_matmul.gf_matmul(coeff, data, dtype, device="cpu")
    assert tuple(got.shape) == (2, 3, 4, 129)
    want = np.asarray(ref_gf_matmul.gf_matmul(coeff, data, dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_and_reconstruct_match_reference():
    data = rng_for("codec").integers(0, 256, (10, 5000), dtype=np.uint8)
    parity = gf_matmul.encode(torch.from_numpy(data), 10, 4)
    ref_parity = np.asarray(ref_gf_matmul.encode(data, 10, 4))
    np.testing.assert_array_equal(parity.numpy(), ref_parity)
    shards = np.concatenate([data, ref_parity])
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    missing, got = gf_matmul.reconstruct(
        shards[present[:10]], present, 10, 4, device="cpu"
    )
    ref_missing, want = ref_gf_matmul.reconstruct(
        shards[present[:10]], present, 10, 4
    )
    assert missing == ref_missing == [0, 5, 11, 13]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), shards[missing])
    assert gf_matmul.reconstruct(shards[:10], range(14), 10, 4,
                                 device="cpu") == ([], None)


def test_bits_helpers_match_reference():
    data = rng_for("bits").integers(0, 256, (3, 10, 77), dtype=np.uint8)
    bits = gf_matmul.unpack_bits(torch.from_numpy(data))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(ref_gf_matmul.unpack_bits(data))
    )
    np.testing.assert_array_equal(gf_matmul.pack_bits(bits).numpy(), data)
    b = bitmatrix.expand_bitmatrix(ref_gf256.parity_matrix(10, 4))
    got = gf_matmul.gf_matmul_bits(b, torch.from_numpy(data), "int8")
    want = np.asarray(ref_gf_matmul.gf_matmul_xla(b, data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_contraction_is_exact():
    """k*8 = 512 > 256: past the reference's bf16 limit, exact here."""
    coeff = rng_for("wide").integers(1, 256, (4, 64), dtype=np.uint8)
    data = rng_for("wide-data").integers(0, 256, (64, 300), dtype=np.uint8)
    for dtype in DTYPES:
        got = gf_matmul.gf_matmul(coeff, torch.from_numpy(data), dtype)
        np.testing.assert_array_equal(got.numpy(),
                                      ref_gf256.gf_matmul_cpu(coeff, data))


def test_unknown_dtype_and_no_card(monkeypatch):
    coeff = ref_gf256.parity_matrix(10, 4)
    with pytest.raises(ValueError):
        gf_matmul.gf_matmul(coeff, torch.zeros((10, 8), dtype=torch.uint8),
                            "float16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        gf_matmul.gf_matmul(coeff, np.zeros((10, 8), np.uint8))
