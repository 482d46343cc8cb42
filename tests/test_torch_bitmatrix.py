"""The port's bit-plane expansion equals the JAX package's: the same
0/1 matrix B[o*8, k*8] for every RS shape of BASELINE config 5 and every
1-4-loss reconstruction matrix of RS(10,4), and the same 8x8 block for
every byte. Tolerance 0: these are exact bit matrices."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.ops import bitmatrix as ref_bitmatrix  # noqa: E402
from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu_torch.ops import bitmatrix, gf256  # noqa: E402

SHAPES = [(6, 3), (10, 4), (12, 4), (20, 4)]


def test_byte_to_bitmatrix_all_bytes():
    for c in range(256):
        np.testing.assert_array_equal(
            bitmatrix.byte_to_bitmatrix(c), ref_bitmatrix.byte_to_bitmatrix(c)
        )


@pytest.mark.parametrize("k,m", SHAPES)
def test_expand_parity_matrix(k, m):
    coeff = ref_gf256.parity_matrix(k, m)
    got = bitmatrix.expand_bitmatrix(gf256.parity_matrix(k, m))
    assert got.shape == (m * 8, k * 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref_bitmatrix.expand_bitmatrix(coeff))


@pytest.mark.parametrize("n_lost", [1, 2, 3, 4])
def test_expand_every_reconstruction_matrix(n_lost):
    """Every loss pattern of n_lost shards out of RS(10,4)'s 14."""
    for lost in itertools.combinations(range(14), n_lost):
        present = [i for i in range(14) if i not in lost]
        r, missing = gf256.reconstruction_matrix(10, 4, present)
        assert missing == list(lost)
        np.testing.assert_array_equal(bitmatrix.expand_bitmatrix(r),
                                      ref_bitmatrix.expand_bitmatrix(r))


def test_numpy_helpers_match():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    bits = bitmatrix.unpack_bits_np(data)
    np.testing.assert_array_equal(bits, ref_bitmatrix.unpack_bits_np(data))
    np.testing.assert_array_equal(bitmatrix.pack_bits_np(bits), data)
    np.testing.assert_array_equal(
        bitmatrix.pack_bits_np(bits[:32]), ref_bitmatrix.pack_bits_np(bits[:32])
    )
    b = bitmatrix.expand_bitmatrix(gf256.parity_matrix(10, 4))
    got = bitmatrix.gf_matmul_bits_np(b, data)
    np.testing.assert_array_equal(got, ref_bitmatrix.gf_matmul_bits_np(b, data))
    np.testing.assert_array_equal(
        got, ref_gf256.gf_matmul_cpu(ref_gf256.parity_matrix(10, 4), data)
    )
