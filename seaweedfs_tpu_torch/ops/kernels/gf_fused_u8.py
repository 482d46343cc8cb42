"""GF(2^8) matrix product on u8 rows in one pass through the tile-local
u32 layout: the wrapper of the Hopper kernel ``csrc/gf_fused_u8.cu``.

Counterpart of ``tools/exp_dev8b.py`` ``fused_u8_kernel`` (:54, built by
``build_fused`` :85): per tile of T bytes, the repack of
``gf_repack`` (quarter s of the tile in byte s of a word), the SWAR
algebra of ``gf_swar`` on the words and the inverse repack, in one kernel.
The output is the plain GF product; the tile is the parameter the
reference's sweep varies. The plain version is that chain in plain
PyTorch: ``repack_plain`` → ``gf_swar.gf_matmul_plain`` →
``unpack_plain`` at the same tile.

A CPU tensor goes through the plain version, a CUDA tensor launches the
kernel or raises. Rows may be strided and the width ragged.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import gf_repack, gf_swar

KERNEL = gf_swar.RowsKernel("gf_fused_u8", (ctypes.c_longlong,))
LAUNCHES = KERNEL.launches
library = KERNEL.library


def _check_tile(tile: int) -> None:
    if tile < 4 or tile % 4:
        raise ValueError(f"tile {tile} is not a positive multiple of 4")


def gf_matmul_plain(coeff: gf_swar.SwarCoeff | np.ndarray,
                    data: torch.Tensor, tile: int) -> torch.Tensor:
    """The plain version: the tile-local repack, the SWAR product on the
    words and the inverse repack, on whatever device ``data`` lies on."""
    _check_tile(tile)
    k = (coeff.matrix if isinstance(coeff, gf_swar.SwarCoeff)
         else np.asarray(coeff)).shape[1]
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    n = data.shape[-1]
    words = gf_repack.repack_plain(data, tile)
    parity = gf_swar.gf_matmul_plain(coeff, words.view(torch.uint8))
    return gf_repack.unpack_plain(parity.view(torch.int32), tile, n)


def gf_matmul(coeff: gf_swar.SwarCoeff | np.ndarray, data: torch.Tensor,
              tile: int) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor whose
    rows may be strided and N ragged, through the layout of ``tile``
    bytes. A CPU tensor goes through :func:`gf_matmul_plain`; a CUDA
    tensor launches the kernel on the current stream."""
    if not isinstance(coeff, gf_swar.SwarCoeff):
        coeff = gf_swar.coeff_from_reference(coeff)
    _check_tile(tile)
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data, tile)
    return KERNEL(coeff, data, tile)
