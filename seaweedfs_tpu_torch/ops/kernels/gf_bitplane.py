"""GF(2^8) matrix product by bit planes on the int8 tensor cores: the
wrapper of the Hopper kernel ``csrc/gf_bitplane.cu``.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py`` ``_mxu_kernel``
(:93, with ``_unpack_bits`` :71 and ``_pack_bits`` :85), built by
``_build_call`` with method ``"mxu"`` (:405-425). The plain version is
``ops.gf_matmul.gf_matmul_bits``. A CPU tensor goes through it, a CUDA
tensor launches the kernel or raises.

The 0/1 matrix B = ``expand_bitmatrix(C)`` depends on the loss pattern, so
it is a run-time input: the wrapper keeps it on the card, padded and cut
into the kernel's tensor-core fragments, cached per (matrix, device).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .. import bitmatrix
from ..gf_matmul import gf_matmul_bits
from . import build
from .build import LaunchCounter

MAX_OUT = 16
MAX_IN = 64
MAX_BATCH = 65535

LAUNCHES = LaunchCounter()

_lib_lock = threading.Lock()
_lib = None  # guarded-by: _lib_lock


def library():
    """The built kernel library (``nvcc`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = build.declare(build.load("gf_bitplane"), {  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
                "gf_bitplane_launch": ([
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p,
                ], ctypes.c_int),
                "gf_bitplane_error_string": ([ctypes.c_int], ctypes.c_char_p),
            })
        return _lib


def fragment_bitmatrix(coeff: np.ndarray) -> np.ndarray:
    """B = expand_bitmatrix(C), zero-padded to [16·MT, 32·KS] (MT =
    ceil(o/2), KS = ceil(k/4)) and cut into the A fragments of
    ``mma.m16n8k32`` as each lane holds them: int8 [MT, KS, 32, 4, 4].
    Lane l = 4g + t of m-tile mt and K slice ks holds, in register r,
    bytes B[16·mt + g + 8·(r & 1), 32·ks + 16·(r >> 1) + 4t + i]."""
    o, k = coeff.shape
    mt, ks = -(-o // 2), -(-k // 4)
    b = np.zeros((mt * 16, ks * 32), dtype=np.int8)
    b[: o * 8, : k * 8] = bitmatrix.expand_bitmatrix(coeff)
    tiles = b.reshape(mt, 16, ks, 32).transpose(0, 2, 1, 3)
    lane = np.arange(32)[:, None, None]
    r = np.arange(4)[None, :, None]
    i = np.arange(4)[None, None, :]
    rows = (lane >> 2) + 8 * (r & 1) + 0 * i
    cols = 16 * (r >> 1) + 4 * (lane & 3) + i
    return np.ascontiguousarray(tiles[:, :, rows, cols])


@functools.lru_cache(maxsize=256)
def _device_bitmatrix(coeff_bytes: bytes, o: int, k: int,
                      device: torch.device) -> torch.Tensor:
    coeff = np.frombuffer(coeff_bytes, dtype=np.uint8).reshape(o, k)
    return torch.from_numpy(fragment_bitmatrix(coeff)).to(device)


def gf_matmul_plain(coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """The plain version: ``gf_matmul_bits`` in float32 sums, exact."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    return gf_matmul_bits(bitmatrix.expand_bitmatrix(coeff), data, "float32")


def gf_matmul(coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor whose
    rows may be strided and N ragged. A CPU tensor goes through
    :func:`gf_matmul_plain`; a CUDA tensor launches the kernel on the
    current stream."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if coeff.ndim != 2 or not (1 <= coeff.shape[0] <= MAX_OUT) or not (
        1 <= coeff.shape[1] <= MAX_IN
    ):
        raise ValueError(
            f"coefficient matrix {coeff.shape} outside the kernel's limits "
            f"(1..{MAX_OUT} outputs, 1..{MAX_IN} inputs)"
        )
    o, k = coeff.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data)
    if data.device.type != "cuda":
        raise ValueError(
            f"gf_bitplane runs on cuda or cpu, not {data.device}"
        )
    *lead, _, n = data.shape
    x = build.rows3d(data)
    batch = x.shape[0]
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch} outside 1..{MAX_BATCH}")
    out = torch.empty((batch, o, n), dtype=torch.uint8, device=data.device)
    if n:
        bmat = _device_bitmatrix(coeff.tobytes(), o, k, data.device)
        lib = library()
        rc = lib.gf_bitplane_launch(
            x.data_ptr(), out.data_ptr(), bmat.data_ptr(), o, k, n, batch,
            x.stride(0), x.stride(1), out.stride(0), out.stride(1),
            data.device.index,
            torch.cuda.current_stream(data.device).cuda_stream,
        )
        build.check_rc(lib.gf_bitplane_error_string, rc, "gf_bitplane")
        LAUNCHES.add()
    return out.reshape(*lead, o, n)
