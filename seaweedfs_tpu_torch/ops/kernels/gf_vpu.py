"""GF(2^8) matrix product with one byte per 32-bit lane: the wrapper of
the Hopper kernel ``csrc/gf_vpu.cu`` and its plain PyTorch version.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py`` ``_vpu_kernel``
(:106, with ``_xtime`` :101), built by ``_build_call`` with method
``"vpu"`` (:427-436): the ``vpu`` route of ``gf_matmul_fused``. The
reference keeps it "for comparison" with the SWAR routes, which do the
same arithmetic on four bytes at once.

A CPU tensor goes through the plain version, a CUDA tensor launches the
kernel or raises. Rows may be strided and the width ragged: the kernel
takes them as they lie, and a batch stays a grid axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf_swar

KERNEL = gf_swar.RowsKernel("gf_vpu")
LAUNCHES = KERNEL.launches
library = KERNEL.library


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """One doubling in GF(2^8)/0x11d of int32 lanes holding one byte each
    (the reference's ``_xtime``)."""
    return ((x << 1) & 0xFF) ^ torch.where(
        (x & 0x80) != 0, x.new_full((), 0x1D), x.new_zeros(()))


def gf_matmul_plain(coeff: gf_swar.SwarCoeff | np.ndarray,
                    data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] in plain tensor ops on
    whatever device ``data`` lies on: the reference's algebra on int32
    tensors, one byte per element, each input row doubled through its
    highest coefficient bit."""
    matrix = coeff.matrix if isinstance(coeff, gf_swar.SwarCoeff) else (
        np.asarray(coeff, dtype=np.uint8))
    o, k = matrix.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
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
