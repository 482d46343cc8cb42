"""The GF(2^8) product by input kind: the port's counterpart of
``seaweedfs_tpu/ops/pallas/gf_kernel.py`` ``gf_matmul_pallas`` (:570-675).

    out[..., o, N] = coeff[o, k] ∘GF data[..., k, N]

Routing is by the kind of input, and the output is always of the same
kind; no route copies a tensor on the card to the host:

- host numpy u8 → to the card, ``swar`` (gf_swar), ``mxu``
  (gf_bitplane) or ``vpu`` (gf_vpu), back as numpy; ``defer=True``
  returns a materialiser that does the copy back when called;
- u32 lane-packed tensor (torch.uint32 or int32, 4 shard bytes a word,
  little-endian: the reference's "device u32") → gf_swar, same dtype back;
- u8 tensor → ``repack`` (gf_repack → gf_swar → gf_unpack), ``swar``
  (gf_swar_u8), ``mxu`` (gf_bitplane) or ``vpu`` (gf_vpu), chosen by
  ``ops/autotune.py`` when ``method`` is None (which, as the reference's,
  never measures ``vpu``).

A tensor on the card launches the routes' kernels or raises; a tensor on
the CPU runs their plain versions. One difference from the reference is
deliberate: host numpy input with ``mxu`` or ``vpu`` comes back as numpy,
as its docstring says, where the reference's bottom route returns a
device array (gf_kernel.py:646-675).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from .. import autotune
from . import gf_bitplane, gf_repack, gf_swar, gf_swar_u8, gf_vpu

METHODS = ("repack", "swar", "mxu", "vpu")
U32_DTYPES = (torch.uint32, torch.int32)


def repack_route(coeff: np.ndarray, data: torch.Tensor,
                 tile_n: int | None = None) -> torch.Tensor:
    """u8 [..., k, n] through the repack chain: gf_repack's tile-local
    words → gf_swar on the words → gf_unpack. The counterpart of
    ``_gf_matmul_u8_repack_device`` (gf_kernel.py:332-368), with the
    reference's tile choice made per [k, n] block; a batch stays a batch
    (the kernels take it as a grid axis) instead of the reference's
    ``moveaxis`` copy. No padding copy: the repack reads past-the-end
    bytes as zeros, and each row of words is padded in place to gf_swar's
    16-byte quantum."""
    sc = gf_swar.coeff_from_reference(coeff)
    *lead, k, n = data.shape
    tile = gf_repack.choose_tile(n, tile_n)
    n4 = gf_repack.padded_width(n, tile) // 4
    if data.device.type == "cpu":
        words = gf_repack.repack(data, tile)
    else:
        words = torch.empty((*lead, k, -(-n4 // 4) * 4), dtype=torch.int32,
                            device=data.device)
        gf_repack.repack(data, tile, out=words[..., :n4])
    parity = gf_swar.gf_matmul(sc, words.view(torch.uint8))
    return gf_repack.unpack(parity.view(torch.int32)[..., :n4], tile, n)


def u32_route(coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """u32 lane-packed [..., k, N4] → [..., o, N4] of the same dtype,
    through gf_swar on the bytes; the counterpart of
    ``gf_matmul_swar_device`` (gf_kernel.py:500)."""
    if data.stride(-1) != 1:
        data = data.contiguous()
    out = gf_swar.gf_matmul(coeff, data.view(torch.uint8))
    return out.view(data.dtype)


def _u8_tensor(coeff: np.ndarray, data: torch.Tensor, method: str | None,
               tile_n: int | None) -> torch.Tensor:
    o, k = coeff.shape
    if method is None:
        if data.device.type == "cuda":
            choice = autotune.best(o, k, kind="dev8")
        else:
            choice = autotune.DEFAULTS["dev8"]
        method = choice.method
        if tile_n is None and choice.tile_n:
            tile_n = choice.tile_n
    if method == "repack":
        return repack_route(coeff, data, tile_n)
    if method == "swar":
        return gf_swar_u8.gf_matmul(coeff, data)
    if method == "vpu":
        return gf_vpu.gf_matmul(coeff, data)
    return gf_bitplane.gf_matmul(coeff, data)


def gf_matmul_fused(coeff: np.ndarray, data, method: str | None = None,
                    tile_n: int | None = None, defer: bool = False,
                    device=None):
    """out[..., o, N] = coeff[o, k] ∘GF data[..., k, N] by the route the
    input's kind selects (module docstring).

    ``tile_n`` is the repack route's tile in bytes (the autotuner's when
    None); ``swar``, ``mxu`` and ``vpu`` have no tile and ignore it.
    ``device`` says where a host numpy array is computed: the card when
    None (raises without one), the plain versions with ``"cpu"``; a
    tensor is computed where it lies and takes no ``device``. Raises as
    the reference does:
    ``defer`` with a tensor or with a method other than ``swar``, a u32
    input with a method other than ``swar``, an unknown method."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if coeff.ndim != 2:
        raise ValueError(f"coefficient matrix must be 2-D, got {coeff.shape}")
    if method is not None and method not in METHODS:
        raise ValueError(f"unknown gf method: {method}")
    is_tensor = isinstance(data, torch.Tensor)
    if defer and (is_tensor or method not in (None, "swar")):
        raise ValueError(
            "defer=True is only supported for host-numpy swar input"
        )

    if not is_tensor:
        host = np.ascontiguousarray(data, dtype=np.uint8)
        if method == "repack":
            raise ValueError("host input has no repack route")
        x = torch.from_numpy(host).to(resolve_device(device))
        if method == "mxu":
            out = gf_bitplane.gf_matmul(coeff, x)
        elif method == "vpu":
            out = gf_vpu.gf_matmul(coeff, x)
        else:
            out = gf_swar.gf_matmul(coeff, x)

        def materialise() -> np.ndarray:
            return out.cpu().numpy()

        return materialise if defer else materialise()

    if device is not None:
        raise ValueError("a tensor is computed where it lies; pass no device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gf_matmul_fused runs on cuda or cpu, not "
                         f"{data.device}")
    if data.dtype in U32_DTYPES:
        if method not in (None, "swar"):
            raise ValueError(
                "u32 lane-packed input supports only the swar path"
            )
        return u32_route(coeff, data)
    if data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8 or u32 lane-packed, got "
                         f"{data.dtype}")
    return _u8_tensor(coeff, data, method, tile_n)
