"""GF(2^8) → GF(2) bit-plane expansion.

Multiplication by a constant c in GF(2^8) is linear over GF(2)^8: an 8×8
bit matrix M_c whose column j holds the bits of c · x^j. A coefficient
matrix C[o, k] therefore expands to a 0/1 matrix B[o*8, k*8] of M_c
blocks, and

    out_bits[o*8, N] = (B @ in_bits[k*8, N]) mod 2

is an ordinary integer matrix product followed by a parity. On the card
the product runs on the int8 tensor cores (``kernels/csrc/gf_bitplane.cu``).

Bit order everywhere: bit j of byte x is (x >> j) & 1; row ``i*8+j`` of B
is bit j of output i and column ``d*8+j`` bit j of input d.

The port's own copy of ``seaweedfs_tpu/ops/bitmatrix.py``; the tests hold
the two equal.
"""

from __future__ import annotations

import numpy as np

from . import gf256


def byte_to_bitmatrix(c: int) -> np.ndarray:
    """8×8 GF(2) matrix of multiply-by-c: M[i, j] = bit i of (c · 2^j)."""
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf256.gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m


def expand_bitmatrix(coeff: np.ndarray) -> np.ndarray:
    """C[o, k] bytes → B[o*8, k*8] bits (uint8 0/1)."""
    o, k = coeff.shape
    b = np.zeros((o * 8, k * 8), dtype=np.uint8)
    for i in range(o):
        for j in range(k):
            b[i * 8 : i * 8 + 8, j * 8 : j * 8 + 8] = byte_to_bitmatrix(
                int(coeff[i, j])
            )
    return b


def unpack_bits_np(x: np.ndarray) -> np.ndarray:
    """[k, N] uint8 → [k*8, N] bits, row d*8+j = bit j of shard d."""
    k, n = x.shape
    shifts = np.arange(8, dtype=np.uint8)
    bits = (x[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(k * 8, n)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """[o*8, N] bits → [o, N] uint8 (inverse of unpack_bits_np)."""
    o8, n = bits.shape
    assert o8 % 8 == 0
    b = bits.reshape(o8 // 8, 8, n).astype(np.uint16)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    return (b * weights).sum(axis=1).astype(np.uint8)


def gf_matmul_bits_np(bitmat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Pure-numpy bit-plane GF matmul — cross-check for the field identity."""
    bits = unpack_bits_np(data)
    acc = bitmat.astype(np.int32) @ bits.astype(np.int32)
    return pack_bits_np((acc & 1).astype(np.uint8))
