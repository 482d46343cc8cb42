"""GF(2^8) matrix product by bit planes on the int8 tensor cores: the
wrapper of the Hopper kernel ``csrc/gf_bitplane.cu``.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py`` ``_mxu_kernel``
(:93, with ``_unpack_bits`` :71 and ``_pack_bits`` :85), built by
``_build_call`` with method ``"mxu"`` (:405-425). The plain version is
``ops.gf_matmul.gf_matmul_bits``. A CPU tensor goes through it, a CUDA
tensor launches the kernel or raises.

The 0/1 matrix B = ``expand_bitmatrix(C)`` depends on the loss pattern, so
it is a run-time input: the wrapper keeps it on the card as the kernel's A
operand (rows and columns in the kernel's order, each bit weighed for the
kernel's B operand, cut into tensor-core fragments), cached per (matrix,
device).
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


# the C launcher's parameters, in order (gf_bitplane_launch)
LAUNCH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in, out, frags
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,  # o, k, n
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,  # batch, in strides
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # out strides, device
    ctypes.c_void_p,  # stream
]


def library():
    """The built kernel library (``nvcc`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = build.declare(build.load("gf_bitplane"), {  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
                "gf_bitplane_launch": (LAUNCH_ARGTYPES, ctypes.c_int),
                "gf_bitplane_error_string": ([ctypes.c_int], ctypes.c_char_p),
            })
        return _lib


def _m_tiles(o: int) -> int:
    """m-tiles of 16 bit rows the kernel gives ``o`` outputs: 2, 4 or 8."""
    return 2 if o <= 4 else 4 if o <= 8 else 8


def _row_order(o: int) -> np.ndarray:
    """(output, bit) of each A row, [MT, 16, 2]: row g + 8h of m-tile mt.
    MT = 2: bit 4(g >> 2) + 2mt + h of output g & 3, so lanes g and g ^ 4
    hold the two nibbles of one output; MT = 4 and 8: bit q & 7 of output
    g + 8(q >> 3), q = 2mt + h, whole bytes a lane."""
    mt_n = _m_tiles(o)
    mt = np.arange(mt_n)[:, None]
    g = (np.arange(16) & 7)[None, :]
    h = (np.arange(16) >> 3)[None, :]
    if mt_n == 2:
        out, bit = g & 3, 4 * (g >> 2) + 2 * mt + h
    else:
        q = 2 * mt + h
        out, bit = g + 8 * (q >> 3), q & 7
    return np.stack(np.broadcast_arrays(out, bit), axis=-1)


def _col_order(k: int) -> np.ndarray:
    """(input, bit) of each A column, [KS, 32, 2]: column kappa of K slice
    ks is bit (kappa & 3) + 4(kappa >> 4) of input 4ks + ((kappa & 15) >>
    2), so the lane that loads input row 4ks + tig feeds both nibbles of
    its bytes to its two B registers."""
    ks = np.arange(-(-k // 4))[:, None]
    kappa = np.arange(32)[None, :]
    d = 4 * ks + ((kappa & 15) >> 2)
    j = (kappa & 3) + 4 * (kappa >> 4)
    return np.stack(np.broadcast_arrays(d, j), axis=-1)


def fragment_bitmatrix(coeff: np.ndarray) -> np.ndarray:
    """The A operand of ``mma.m16n8k32``: B = expand_bitmatrix(C) with its
    rows in :func:`_row_order` and its columns in :func:`_col_order`, zero
    where the output or input is past o or k, cut into the fragments each
    lane holds: int8 [MT, KS, 32, 4, 4]. Lane l = 4g + t of m-tile mt and
    K slice ks holds, in register r, bytes A[mt, g + 8(r & 1), ks, 16(r >>
    1) + 4t + i]. Bit j of an input is weighed by 2^(7-j) (int8: j = 0 is
    -128) against the kernel's B operand, which keeps it in place (x &
    2^j): every product is 0 or +-128, so bit 7 of a sum is its parity and
    its low 7 bits are 0."""
    o, k = coeff.shape
    bits = bitmatrix.expand_bitmatrix(coeff).astype(np.int64)
    rows, cols = _row_order(o), _col_order(k)
    out, bit = rows[..., 0], rows[..., 1]           # [MT, 16]
    d, j = cols[..., 0], cols[..., 1]               # [KS, 32]
    live = (out < o)[:, :, None, None] & (d < k)[None, None]
    a = bits[np.minimum(8 * out + bit, 8 * o - 1)[:, :, None, None],
             np.minimum(8 * d + j, 8 * k - 1)[None, None]]
    a = np.where(live, a << (7 - j)[None, None], 0)
    a = a.astype(np.uint8).view(np.int8)
    lane = np.arange(32)[:, None, None]
    r = np.arange(4)[None, :, None]
    i = np.arange(4)[None, None, :]
    rr = (lane >> 2) + 8 * (r & 1) + 0 * i
    cc = 16 * (r >> 1) + 4 * (lane & 3) + i
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)[:, :, rr, cc])


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
