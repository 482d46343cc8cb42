"""Tile-local byte repack of shard rows into u32 words and its inverse:
the wrappers of the Hopper kernels in ``csrc/gf_repack.cu`` and their
plain PyTorch versions.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py``:
``repack`` replaces ``_repack_block_kernel`` (:266) and ``unpack``
``_unpack_block_kernel`` (:279), the two ends of the device-u8 ``repack``
route (``_build_u8_repack_chain``, :289). Per tile of T bytes with
q = T / 4, word ``t*q + j`` of a row holds bytes ``t*T + s*q + j`` for
s = 0..3, quarter s in byte s; bytes past the row's width are zeros.

A CPU tensor goes through the plain version, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import build
from .build import LaunchCounter

DEFAULT_TILE_N = 65536
MAX_ROWS = 65535  # batch * rows: the kernels' gridDim.y

REPACK_LAUNCHES = LaunchCounter()
UNPACK_LAUNCHES = LaunchCounter()


def choose_tile(total: int, tile_n: int | None = None) -> int:
    """The reference's tile for a row of ``total`` bytes
    (``_gf_matmul_u8_repack_device``, gf_kernel.py:353-356): ``tile_n``
    (65536 when None), halved while larger than ``total`` and above 4."""
    tile = DEFAULT_TILE_N if tile_n is None else tile_n
    tile = min(tile, 1 << 30)
    while tile > 4 and tile > total:
        tile //= 2
    if tile % 4:
        raise ValueError(f"tile {tile} is not a multiple of 4")
    return tile


def padded_width(n: int, tile: int) -> int:
    """``n`` rounded up to whole tiles."""
    return -(-n // tile) * tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def repack_plain(data: torch.Tensor, tile: int) -> torch.Tensor:
    """u8 [..., k, n] → int32 [..., k, n_pad/4] words of the tile-local
    repack (n_pad = ``padded_width(n, tile)``)."""
    *lead, k, n = data.shape
    n_pad = padded_width(n, tile)
    if n_pad == 0:
        return data.new_empty((*lead, k, 0), dtype=torch.int32)
    x = F.pad(data, (0, n_pad - n)) if n_pad != n else data
    q = tile // 4
    x = x.reshape(*lead, k, n_pad // tile, 4, q).transpose(-1, -2)
    return x.reshape(*lead, k, n_pad).view(torch.int32)


def unpack_plain(words: torch.Tensor, tile: int, n: int) -> torch.Tensor:
    """int32 [..., o, n4] → u8 [..., o, n], the inverse of the repack
    cut to the first ``n`` bytes of each row."""
    *lead, o, n4 = words.shape
    if n4 == 0:
        return words.new_empty((*lead, o, 0), dtype=torch.uint8)
    q = tile // 4
    x = words.contiguous().view(torch.uint8)
    x = x.reshape(*lead, o, n4 // q, q, 4)
    x = x.transpose(-1, -2).reshape(*lead, o, 4 * n4)
    return x[..., :n].contiguous()


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None  # guarded-by: _lib_lock

_LAUNCH_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


def library():
    """The built kernel library (``nvcc`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = build.declare(build.load("gf_repack"), {  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
                "gf_repack_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "gf_unpack_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "gf_repack_error_string": ([ctypes.c_int], ctypes.c_char_p),
            })
        return _lib


def _launch(fn: str, src: torch.Tensor, dst: torch.Tensor, n: int,
            n4: int, q: int) -> None:
    batch, rows, _ = src.shape
    if batch * rows > MAX_ROWS:
        raise ValueError(f"{batch} x {rows} rows past the kernel's {MAX_ROWS}")
    lib = library()
    rc = getattr(lib, fn)(
        src.data_ptr(), dst.data_ptr(), batch, rows, n, n4, q,
        src.stride(0), src.stride(1), dst.stride(0), dst.stride(1),
        src.device.index, torch.cuda.current_stream(src.device).cuda_stream,
    )
    build.check_rc(lib.gf_repack_error_string, rc, fn)


def _check(t: torch.Tensor, dtypes, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if t.dtype not in dtypes or t.dim() < 2:
        raise ValueError(
            f"{what} needs a [..., rows, N] tensor of {dtypes}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def repack(data: torch.Tensor, tile: int,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """u8 [..., k, n] → int32 [..., k, n_pad/4] tile-local words. On the
    card the words go into ``out`` when given (a [..., k, n_pad/4] int32
    tensor whose rows may be a strided view of a wider buffer), else into
    a new tensor; the input rows may be strided too."""
    _check(data, (torch.uint8,), "repack")
    if tile % 4 or tile < 4:
        raise ValueError(f"tile {tile} is not a positive multiple of 4")
    if data.device.type == "cpu":
        return repack_plain(data, tile)
    *lead, k, n = data.shape
    n4 = padded_width(n, tile) // 4
    if out is None:
        out = torch.empty((*lead, k, n4), dtype=torch.int32,
                          device=data.device)
    if (out.dtype != torch.int32 or out.device != data.device
            or tuple(out.shape) != (*lead, k, n4)):
        raise ValueError(f"out must be int32 {(*lead, k, n4)} on "
                         f"{data.device}")
    if n4:
        dst = build.rows3d(out)
        if dst.data_ptr() != out.data_ptr() or out.stride(-1) != 1:
            raise ValueError("out must take a [B, rows, W] view")
        _launch("gf_repack_launch", build.rows3d(data), dst, n, n4, tile // 4)
        REPACK_LAUNCHES.add()
    return out


def unpack(words: torch.Tensor, tile: int, n: int) -> torch.Tensor:
    """int32 (or uint32) [..., o, n4] words → u8 [..., o, n], the exact
    inverse of :func:`repack`; ``n`` ≤ 4·n4 is the width to keep. The
    words' rows may be a strided view of a wider buffer."""
    _check(words, (torch.int32, torch.uint32), "unpack")
    *lead, o, n4 = words.shape
    q = tile // 4
    if tile % 4 or tile < 4 or n4 % q or not 0 <= n <= 4 * n4:
        raise ValueError(f"{n4} words do not hold {n} bytes in tiles of "
                         f"{tile}")
    if words.device.type == "cpu":
        return unpack_plain(words.view(torch.int32), tile, n)
    out = torch.empty((*lead, o, n), dtype=torch.uint8, device=words.device)
    if n:
        _launch("gf_unpack_launch", build.rows3d(words), build.rows3d(out),
                n, n4, q)
        UNPACK_LAUNCHES.add()
    return out
