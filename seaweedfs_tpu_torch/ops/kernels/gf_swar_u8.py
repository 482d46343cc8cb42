"""GF(2^8) matrix product straight from u8 rows of any width and row
stride: the wrapper of the Hopper kernel ``csrc/gf_swar_u8.cu``.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py``
``_gf_matmul_swar_u8_device`` (:516) and its kernel ``_swar_u8_kernel``
(:202): method ``"swar"`` on a device-u8 slab. The plain version is
``gf_swar.gf_matmul_plain`` on a contiguous copy of the input. A CPU
tensor goes through it, a CUDA tensor launches the kernel or raises.

The route makes no copy of its input: a ragged width and strided rows
(the first k rows of a [k+m, N] shard tensor) go to the kernel as they
lie, and the output is a new contiguous [..., o, N] tensor.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import build, gf_swar
from .build import LaunchCounter

LAUNCHES = LaunchCounter()

_lib_lock = threading.Lock()
_lib = None  # guarded-by: _lib_lock


def library():
    """The built kernel library (``nvcc`` at first use), its argument
    struct checked against gf_swar's packing."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.declare(build.load("gf_swar_u8"), {  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
                "gf_swar_u8_launch": ([
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_void_p,
                ], ctypes.c_int),
                "gf_swar_u8_error_string": ([ctypes.c_int], ctypes.c_char_p),
                "gf_swar_u8_coeff_bytes": ([], ctypes.c_int),
            })
            want = gf_swar.MAX_IN * 8 * 2 + gf_swar.MAX_IN
            if lib.gf_swar_u8_coeff_bytes() != want:
                raise RuntimeError(
                    f"gf_swar_u8 takes {lib.gf_swar_u8_coeff_bytes()} "
                    f"coefficient bytes, gf_swar packs {want}"
                )
            _lib = lib
        return _lib


def gf_matmul_plain(coeff, data: torch.Tensor) -> torch.Tensor:
    """The plain version: gf_swar's on a contiguous copy."""
    return gf_swar.gf_matmul_plain(coeff, data.contiguous())


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
    if data.device.type != "cuda":
        raise ValueError(f"gf_swar_u8 runs on cuda or cpu, not {data.device}")
    o, k = coeff.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    *lead, _, n = data.shape
    x = build.rows3d(data)
    batch = x.shape[0]
    if not 1 <= batch <= gf_swar.MAX_BATCH:
        raise ValueError(f"batch {batch} outside 1..{gf_swar.MAX_BATCH}")
    out = torch.empty((batch, o, n), dtype=torch.uint8, device=data.device)
    if n:
        lib = library()
        rc = lib.gf_swar_u8_launch(
            x.data_ptr(), out.data_ptr(), o, k, n, batch, x.stride(0),
            x.stride(1), out.stride(0), out.stride(1), coeff.packed,
            data.device.index,
            torch.cuda.current_stream(data.device).cuda_stream,
        )
        build.check_rc(lib.gf_swar_u8_error_string, rc, "gf_swar_u8")
        LAUNCHES.add()
    return out.reshape(*lead, o, n)
