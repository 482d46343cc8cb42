"""GF(2^8) matrix product of the ``vpu`` route: the wrapper of the Hopper
kernel ``csrc/gf_vpu.cu`` and its plain PyTorch version.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py`` ``_vpu_kernel``
(:106, with ``_xtime`` :101), built by ``_build_call`` with method
``"vpu"`` (:427-436): the ``vpu`` route of ``gf_matmul_fused``. The
reference keeps it "for comparison" with the SWAR routes. It holds one
byte per int32 lane and doubles it through each coefficient bit; the
plain version here does the same. The kernel instead looks products up
in split product tables with byte permutes, four bytes a register
(:func:`gf_matmul_tables` models it step by step for the tests).

A CPU tensor goes through the plain version, a CUDA tensor launches the
kernel or raises. Rows may be strided and the width ragged: the kernel
takes them as they lie, and a batch stays a grid axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import gf_swar

KERNEL = gf_swar.RowsKernel("gf_vpu")
LAUNCHES = KERNEL.launches
library = KERNEL.library


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """One doubling in GF(2^8)/0x11d of int32 lanes holding one byte each
    (the reference's ``_xtime``)."""
    return ((x << 1) & 0xFF) ^ torch.where(
        (x & 0x80) != 0, x.new_full((), 0x1D), x.new_zeros(()))


def _checked_matrix(coeff: gf_swar.SwarCoeff | np.ndarray,
                    data: torch.Tensor) -> np.ndarray:
    """The u8 [o, k] matrix of ``coeff``; raises unless ``data`` is uint8
    [..., k, N]."""
    matrix = coeff.matrix if isinstance(coeff, gf_swar.SwarCoeff) else (
        np.asarray(coeff, dtype=np.uint8))
    k = matrix.shape[1]
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    return matrix


def gf_matmul_plain(coeff: gf_swar.SwarCoeff | np.ndarray,
                    data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] in plain tensor ops on
    whatever device ``data`` lies on: the reference's algebra on int32
    tensors, one byte per element, each input row doubled through its
    highest coefficient bit."""
    matrix = _checked_matrix(coeff, data)
    o, k = matrix.shape
    acc: list[torch.Tensor | None] = [None] * o
    for d in range(k):
        col = [int(c) for c in matrix[:, d]]
        top = max(c.bit_length() for c in col)
        if not top:
            continue
        x = data[..., d, :].to(torch.int32)
        for b in range(top):
            if b:
                x = _xtime(x)
            for i in range(o):
                if col[i] >> b & 1:
                    acc[i] = x if acc[i] is None else acc[i] ^ x
    zero = torch.zeros(data[..., 0, :].shape, dtype=torch.int32,
                       device=data.device)
    out = torch.stack([a if a is not None else zero for a in acc], dim=-2)
    return out.to(torch.uint8)


def gf_matmul(coeff: gf_swar.SwarCoeff | np.ndarray,
              data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor whose
    rows may be strided and N ragged. A CPU tensor goes through
    :func:`gf_matmul_plain`; a CUDA tensor launches the kernel on the
    current stream."""
    if not isinstance(coeff, gf_swar.SwarCoeff):
        coeff = gf_swar.coeff_from_reference(coeff)
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data)
    return KERNEL(coeff, data)


# The kernel's table words of a coefficient c (csrc/gf_vpu.cu): c times the
# four bytes of each, little-endian. L0 = c·(0..7), L1 = c·((0..7) << 3),
# L2 = c·((0..3) << 6).
TABLE_BYTES = (0x03020100, 0x07060504, 0x18100800, 0x38302820, 0xC0804000)
_SHIFTS = torch.tensor([0, 8, 16, 24], dtype=torch.int64)


def byte_perm(x: torch.Tensor, y: torch.Tensor, s) -> torch.Tensor:
    """PRMT in its default mode (``__byte_perm``) on int64 tensors holding
    u32 words: byte j of the result is byte ``s >> 4j & 7`` of the eight
    bytes {y:x}, replaced by its sign replicated when bit 3 of that
    selector nibble is set."""
    s = torch.as_tensor(s, dtype=torch.int64)
    out = torch.zeros_like(x)
    for j in range(4):
        sel = (s >> (4 * j)) & 0xF
        src = torch.where((sel & 4) != 0, y, x)
        byte = (src >> (8 * (sel & 3))) & 0xFF
        byte = torch.where((sel & 8) != 0,
                           torch.where((byte & 0x80) != 0, 0xFF, 0), byte)
        out = out | (byte << (8 * j))
    return out


def product_tables(matrix: np.ndarray) -> torch.Tensor:
    """int64 [o, k, 5]: the five table words the kernel builds for each
    coefficient (:data:`TABLE_BYTES` scaled by C[i, d]), built as the
    kernel builds them: the four bytes doubled through the bits of c."""
    c = torch.from_numpy(np.array(matrix, dtype=np.int64))
    v = torch.tensor(TABLE_BYTES, dtype=torch.int64).expand(*c.shape, 5)
    acc = torch.zeros_like(v)
    for b in range(8):
        acc = torch.where(((c >> b) & 1).bool()[..., None], acc ^ v, acc)
        v = (((v & 0x7F7F7F7F) << 1)
             ^ (((v >> 7) & 0x01010101) * 0x1D))
    return acc


def pair_selectors(a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """The kernel's six selectors of word pair (a, b): piece p (bits 0-2,
    3-5, 6-7) of a's byte j in the low and of b's in the high nibble of
    byte j; [0..2] as they are (columns a0 b0 a1 b1), [3..5] >> 16
    (a2 b2 a3 b3)."""
    s = [(a & 0x07070707) | ((b & 0x07070707) << 4),
         ((a >> 3) & 0x07070707) | ((b << 1) & 0x70707070),
         ((a >> 6) & 0x03030303) | ((b >> 2) & 0x30303030)]
    return s + [x >> 16 for x in s]


def table_lookup(t: torch.Tensor, s: list[torch.Tensor]) -> torch.Tensor:
    """c·x of the four columns selectors ``s`` (three) pick, from c's five
    table words ``t``: three byte permutes, XORed."""
    zero = torch.zeros((), dtype=torch.int64)
    return (byte_perm(t[0], t[1], s[0]) ^ byte_perm(t[2], t[3], s[1])
            ^ byte_perm(t[4], zero, s[2]))


def gf_matmul_tables(coeff: gf_swar.SwarCoeff | np.ndarray,
                     data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] step by step as the
    kernel computes it: words of four bytes in pairs, their selectors,
    three byte-permute lookups a coefficient, XOR over the rows, and the
    two permutes that put the interleaved columns back. For the tests,
    on the CPU."""
    matrix = _checked_matrix(coeff, data)
    o, k = matrix.shape
    n = data.shape[-1]
    x = F.pad(data, (0, -n % 8)).to(torch.int64)
    words = (x.reshape(*x.shape[:-1], -1, 2, 4) << _SHIFTS).sum(-1)
    sel = pair_selectors(words[..., 0], words[..., 1])  # each [..., k, P]
    tables = product_tables(matrix)
    lo = torch.zeros(words.shape[:-3] + (o, words.shape[-2]),
                     dtype=torch.int64)
    hi = torch.zeros_like(lo)
    for d in range(k):
        t = tables[:, d].T[..., None]  # [5, o, 1]: every output at once
        s_d = [s[..., d:d + 1, :] for s in sel]  # [..., 1, P]
        lo ^= table_lookup(t, s_d[:3])
        hi ^= table_lookup(t, s_d[3:])
    out = torch.stack([byte_perm(lo, hi, 0x6420), byte_perm(lo, hi, 0x7531)],
                      dim=-1)
    out = (out[..., None] >> _SHIFTS) & 0xFF
    return out.reshape(*out.shape[:-3], -1)[..., :n].to(torch.uint8)
