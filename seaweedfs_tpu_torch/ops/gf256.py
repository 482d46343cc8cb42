"""GF(2^8) arithmetic and Reed-Solomon coding matrices.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d)
and generator 2, the field of the klauspost/reedsolomon codec SeaweedFS
encodes with, so shard bytes are byte-identical to its ``.ec00–.ec13``.

Matrix construction is the Vandermonde-systematic scheme of that codec:
build an (n×k) Vandermonde matrix V[r,c] = r^c, then right-multiply by
inv(V[:k]) so the top k rows become the identity and the bottom m rows
are the parity coefficients.

Everything here is host-side numpy: small coefficient matrices and the
``gf_matmul_cpu`` oracle. The port's own copy of
``seaweedfs_tpu/ops/gf256.py``; the tests hold the two equal.
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GF_GENERATOR = 2


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables. exp is doubled (512 entries) so mul can skip the mod."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = -1  # log(0) is undefined; callers must special-case zero
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(256). 0**0 == 1 by the Vandermonde convention."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table, MUL[a, b] = a*b in GF(256)."""
    t = np.zeros((256, 256), dtype=np.uint8)
    for a in range(1, 256):
        t[a, 1:] = GF_EXP[GF_LOG[a] + GF_LOG[1:256]]
    return t


# ---------------------------------------------------------------------------
# Matrix algebra over GF(256) (small host-side matrices only)
# ---------------------------------------------------------------------------


def gf_mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r×n) ∘GF (n×c) matrix product."""
    mt = mul_table()
    r, n = a.shape
    n2, c = b.shape
    if n != n2:
        raise ValueError(f"shape mismatch {a.shape} x {b.shape}")
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(r):
        for t in range(n):
            out[i] ^= mt[a[i, t], b[t]]
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(256); raises if singular."""
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    mt = mul_table()
    aug = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_div(1, int(aug[col, col]))
        aug[col] = mt[inv_p, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= mt[int(aug[row, col]), aug[col]]
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r,c] = r^c in GF(256): any square submatrix of distinct rows is
    invertible, which is what makes every k-subset of shards decodable."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_pow(r, c)
    return v


@functools.lru_cache(maxsize=32)
def rs_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic (n×k) coding matrix: identity on top, parity rows below.

    shards[n, N] = rs_matrix(k, m) ∘GF data[k, N]. Cached, so callers
    get a read-only array."""
    n = data_shards + parity_shards
    vm = vandermonde(n, data_shards)
    top_inv = gf_mat_inv(vm[:data_shards])
    out = gf_mat_mul(vm, top_inv)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=32)
def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (m×k) parity coefficient rows of rs_matrix (read-only)."""
    out = rs_matrix(data_shards, parity_shards)[data_shards:].copy()
    out.flags.writeable = False
    return out


def reconstruction_matrix(
    data_shards: int, parity_shards: int, present: tuple[int, ...] | list[int]
) -> tuple[np.ndarray, list[int]]:
    """Coefficient rows that rebuild every missing shard from present ones.

    `present` lists the shard ids (0..n-1) that survive; at least
    `data_shards` of them are required. Returns (R, missing) where
    missing_shards[len(missing), N] = R ∘GF present_k_shards[k, N]
    using the FIRST k present shards in ascending id order — the
    selection rule of the reference's Reconstruct path, which keeps
    rebuilt bytes identical.
    """
    n = data_shards + parity_shards
    present = sorted(set(int(p) for p in present))
    if len(present) < data_shards:
        raise ValueError(
            f"need >= {data_shards} shards to reconstruct, have {len(present)}"
        )
    full = rs_matrix(data_shards, parity_shards)
    use = present[:data_shards]
    dec = gf_mat_inv(full[use])  # data[k,N] = dec ∘ present_used[k,N]
    present_set = set(present)
    missing = [i for i in range(n) if i not in present_set]
    if not missing:
        return np.zeros((0, data_shards), dtype=np.uint8), []
    return gf_mat_mul(full[missing], dec), missing


# ---------------------------------------------------------------------------
# Host-side (numpy) oracle
# ---------------------------------------------------------------------------


def gf_matmul_cpu(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[o, N] = coeff[o, k] ∘GF data[k, N] via LUT gathers (vectorized)."""
    mt = mul_table()
    o, k = coeff.shape
    k2, n = data.shape
    if k != k2:
        raise ValueError(f"shape mismatch {coeff.shape} x {data.shape}")
    out = np.zeros((o, n), dtype=np.uint8)
    for i in range(o):
        acc = out[i]
        for t in range(k):
            c = int(coeff[i, t])
            if c == 0:
                continue
            if c == 1:
                acc ^= data[t]
            else:
                acc ^= mt[c, data[t]]
    return out


def encode_cpu(data: np.ndarray, parity_shards: int) -> np.ndarray:
    """parity[m, N] from data[k, N] — the numpy oracle for the kernels."""
    return gf_matmul_cpu(parity_matrix(data.shape[0], parity_shards), data)


def reconstruct_cpu(
    shards: dict[int, np.ndarray], data_shards: int, parity_shards: int
) -> dict[int, np.ndarray]:
    """Rebuild all missing shards from a dict of present {shard_id: bytes}."""
    r, missing = reconstruction_matrix(
        data_shards, parity_shards, tuple(sorted(shards))
    )
    if not missing:
        return {}
    use = sorted(shards)[:data_shards]
    rebuilt = gf_matmul_cpu(r, np.stack([shards[i] for i in use], axis=0))
    return {sid: rebuilt[i] for i, sid in enumerate(missing)}
