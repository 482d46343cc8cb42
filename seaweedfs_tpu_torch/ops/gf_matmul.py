"""GF(2^8) matrix product by bit planes, in plain PyTorch.

out[o, N] = C[o, k] ∘GF data[k, N], computed as: unpack bytes to bits,
multiply by the 0/1 matrix B = ``bitmatrix.expand_bitmatrix(C)``, keep
bit 0 of each sum, pack bits to bytes.

The counterpart of ``seaweedfs_tpu/ops/gf_matmul.py``, where the product
is a plain XLA matrix product; here it is ``torch.matmul``. This is the
plain version of the bit-plane kernel (``kernels/gf_bitplane.py``): the
CPU path and the card-side check. Nothing on the card's path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import bitmatrix, gf256

COMPUTE_DTYPES = ("bfloat16", "float32", "int8")


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., k, N] uint8 → [..., k*8, N] bits (uint8 0/1)."""
    *lead, k, n = x.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[..., :, None, :] >> shifts[:, None]) & 1
    return bits.reshape(*lead, k * 8, n)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., o*8, N] integer bits → [..., o, N] uint8."""
    *lead, o8, n = bits.shape
    b = bits.reshape(*lead, o8 // 8, 8, n).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights[:, None]).sum(dim=-2).to(torch.uint8)


def gf_matmul_bits(bitmat, data: torch.Tensor,
                   compute_dtype: str = "bfloat16") -> torch.Tensor:
    """bitmat [o*8, k*8] (0/1), data [..., k, N] uint8 → [..., o, N] uint8.

    Counterpart of ``gf_matmul.gf_matmul_xla``. The bits and the matrix
    are cast to ``compute_dtype`` as there; the sums are taken in float32
    for bfloat16 and float32 (the reference's float32 accumulation) and
    in int32 for int8. Every value is 0 or 1 and every sum at most k*8, so
    the casts and the sums are exact. PyTorch has no integer matrix
    product on the card, so there int8 sums run in float32, exact as
    well (k*8 ≤ 512 < 2^24)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype {compute_dtype!r} not in {COMPUTE_DTYPES}"
        )
    bm = torch.as_tensor(np.asarray(bitmat, dtype=np.uint8),
                         device=data.device)
    dtype = getattr(torch, compute_dtype)
    bits = unpack_bits(data).to(dtype)
    bm = bm.to(dtype)
    if compute_dtype == "int8" and data.device.type == "cpu":
        acc = torch.matmul(bm.to(torch.int32), bits.to(torch.int32))
    else:
        acc = torch.matmul(bm.to(torch.float32), bits.to(torch.float32))
    return pack_bits(acc.to(torch.int32) & 1)


def _as_tensor(data, device) -> torch.Tensor:
    """``data`` as a uint8 tensor on the device the call runs on: a
    tensor's own device unless ``device`` names another, a numpy array on
    ``resolve_device(device)`` (the card unless ``device="cpu"``)."""
    if isinstance(data, torch.Tensor):
        dev = data.device if device is None else resolve_device(device)
        return data.to(dev, torch.uint8)
    return torch.from_numpy(
        np.ascontiguousarray(data, dtype=np.uint8)
    ).to(resolve_device(device))


def gf_matmul(coeff: np.ndarray, data, compute_dtype: str = "bfloat16",
              device=None) -> torch.Tensor:
    """GF matmul with a host-side byte coefficient matrix; ``data`` is
    [..., k, N] uint8, a tensor or a numpy array."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    return gf_matmul_bits(bitmatrix.expand_bitmatrix(coeff),
                          _as_tensor(data, device), compute_dtype)


def encode(data, data_shards: int, parity_shards: int,
           device=None) -> torch.Tensor:
    """parity[..., m, N] from data[..., k, N]."""
    return gf_matmul(gf256.parity_matrix(data_shards, parity_shards), data,
                     device=device)


def reconstruct(present_stack, present_ids, data_shards: int,
                parity_shards: int, device=None):
    """missing[..., len(missing), N] from the first-k present shards.

    present_stack: [..., k, N] uint8, the first ``data_shards`` surviving
    shards in ascending shard-id order. Returns (missing_ids, tensor)."""
    r, missing = gf256.reconstruction_matrix(
        data_shards, parity_shards, tuple(present_ids)
    )
    if not missing:
        return [], None
    return missing, gf_matmul(r, present_stack, device=device)
