"""GF(2^8) matrix product over packed bytes: the wrapper of the Hopper
kernel ``csrc/gf_swar.cu`` and its plain PyTorch version.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py``: the wrapper
takes the place of ``gf_matmul_swar`` (:448), ``gf_matmul_swar_device``
(:500) and ``_build_swar_call`` (:176); the CUDA kernel that of
``_swar_kernel`` (:146) with ``_xtime_swar`` (:137).

    out[..., o, N] = C[o, k] ∘GF data[..., k, N]     over GF(2^8)/0x11d

``gf_matmul`` picks by the tensor it is given: a CPU tensor goes through
:func:`gf_matmul_plain`, a CUDA tensor launches the kernel or raises.
There is no fallback from one to the other.

Two more launch forms of the kernel's column work take u32 words
[V, k, n4] of V volumes and answer the batch-geometry questions of
``tools/exp_batched.py``: :func:`gf_matmul_batch_fastest` (its swapped
grid of ``_swar_kernel``, ``build_batched_swapped`` :64) and
:func:`gf_matmul_fusedv` (its ``_swar_fusedv_kernel`` :27). Their plain
version is the batched :func:`gf_matmul_plain`.

Each launch takes two choices that this module alone makes
(:func:`launch_plan`): the column words a thread takes (W, from the
launch's size and the card's SM count, :func:`choose_width`), and the
coefficient form: the compile-time RS(10,4) parity instantiation for a
coefficient :func:`coeff_from_reference` marked as that matrix, the
run-time struct for every other.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import gf256
from . import build
from .build import LaunchCounter

# Shape limits of the kernel (csrc/gf_swar.cu: kMaxOut, kMaxIn); the
# wrapper raises past them.
MAX_OUT = 16
MAX_IN = 64
MAX_BATCH = 65535
# Row width quantum of the kernel: one uint4 (16 bytes), a column word.
QUANTUM = 16
# Column words a thread may take (the kernel's template parameter W).
WIDTHS = (1, 2)
# A wider W is taken only while the launch still gives every SM this many
# threads (16 warps): the encode's [10, 1 MiB] launch, 65,536 words, has
# about 500 a SM at W = 1 and keeps W = 1.
MIN_THREADS_PER_SM = 512
# The coefficient forms of the launchers' ``form`` argument.
FORM_RUNTIME = 0
FORM_RS10X4 = 1


LAUNCHES = LaunchCounter()
BATCH_FASTEST_LAUNCHES = LaunchCounter()
FUSEDV_LAUNCHES = LaunchCounter()
# launches of any of the three forms that took the compile-time RS(10,4)
# parity instantiation
RS10X4_LAUNCHES = LaunchCounter()


@dataclass(frozen=True)
class SwarCoeff:
    """A coefficient matrix in the kernel's argument form.

    ``matrix`` is the u8 [o, k] matrix itself (the plain version's
    input); ``packed`` the bytes of the kernel's ``SwarCoeff`` struct:
    ``mask[64][8]`` u16, bit i of mask[d][b] set when bit b of
    matrix[i, d] is set, then ``top[64]`` u8, the number of bits input
    row d needs. ``rs10x4`` is set when ``matrix`` is the RS(10,4)
    parity, which the kernel also holds as compile-time constants."""

    matrix: np.ndarray
    packed: bytes
    rs10x4: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return self.matrix.shape


def coeff_from_reference(coeff: np.ndarray) -> SwarCoeff:
    """Turn a u8 [o, k] matrix, as ``gf256.parity_matrix`` or
    ``gf256.reconstruction_matrix`` return it (either package's), into
    the kernel's argument form. Raises on a shape past the kernel's
    limits."""
    m = np.array(coeff, dtype=np.uint8, copy=True)
    if m.ndim != 2 or not (1 <= m.shape[0] <= MAX_OUT) or not (
        1 <= m.shape[1] <= MAX_IN
    ):
        raise ValueError(
            f"coefficient matrix {m.shape} outside the kernel's limits "
            f"(1..{MAX_OUT} outputs, 1..{MAX_IN} inputs)"
        )
    o, k = m.shape
    bits = (m[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1  # [o, k, 8]
    weights = (1 << np.arange(o, dtype=np.uint32))[:, None, None]
    mask = np.zeros((MAX_IN, 8), dtype="<u2")
    mask[:k] = (bits.astype(np.uint32) * weights).sum(axis=0)
    top = np.zeros(MAX_IN, dtype=np.uint8)
    col_or = np.bitwise_or.reduce(m, axis=0)
    top[:k] = [int(c).bit_length() for c in col_or]
    m.flags.writeable = False
    rs10x4 = m.shape == (4, 10) and np.array_equal(m, _rs10x4_parity())
    return SwarCoeff(m, mask.tobytes() + top.tobytes(), rs10x4)


@functools.lru_cache(maxsize=1)
def _rs10x4_parity() -> np.ndarray:
    """The matrix of the kernels' compile-time form
    (csrc/gf_swar_column.cuh: rs10x4_coef)."""
    return gf256.parity_matrix(10, 4)


def max_width(o: int, form: int = FORM_RUNTIME) -> int:
    """The widest W the kernels have for ``o`` outputs in ``form``
    (csrc/gf_swar_column.cuh: max_width): 2 in the run-time form for up
    to 4 outputs, whose 8 accumulator words stay in registers, else 1;
    the compile-time form has W = 1 only."""
    return 2 if form == FORM_RUNTIME and o <= 4 else 1


def choose_width(n16: int, threads_over: int, o: int, sms: int,
                 form: int = FORM_RUNTIME) -> int:
    """Column words a thread takes for a launch of ``n16`` column words
    in each of ``threads_over`` independent slices (the batch, or 1 for
    the fused-volume form): :func:`max_width` where that still leaves
    :data:`MIN_THREADS_PER_SM` threads on each of ``sms`` SMs, else 1.
    A wider W shares the run-time form's per-bit tests among more words;
    the compile-time form has none to share."""
    w = max_width(o, form)
    if w > 1 and threads_over * -(-n16 // w) >= sms * MIN_THREADS_PER_SM:
        return w
    return 1


def launch_plan(coeff: SwarCoeff, n16: int, threads_over: int,
                sms: int) -> tuple[int, int]:
    """(W, form) of one launch: the compile-time form for a coefficient
    marked ``rs10x4``, the run-time one else, and :func:`choose_width`
    for that form."""
    form = FORM_RS10X4 if coeff.rs10x4 else FORM_RUNTIME
    return choose_width(n16, threads_over, coeff.shape[0], sms, form), form


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and the card-side check in
# chip_smoke.py)
# ---------------------------------------------------------------------------


def _xtime_i32(x: torch.Tensor) -> torch.Tensor:
    """Byte-parallel doubling of 4 packed bytes per int32 lane. ``>>`` on
    int32 is arithmetic, so the mask after it clears the sign copies;
    the ``<<`` wraps into the sign bit, which is the byte we want."""
    return ((x & 0x7F7F7F7F) << 1) ^ (((x >> 7) & 0x01010101) * 0x1D)


def gf_matmul_plain(coeff: SwarCoeff | np.ndarray, data: torch.Tensor):
    """out[..., o, N] = coeff ∘GF data[..., k, N] in plain tensor ops on
    whatever device ``data`` lies on: the kernel's algebra on int32
    lanes of 4 bytes (torch.uint32 has few kernels)."""
    matrix = coeff.matrix if isinstance(coeff, SwarCoeff) else np.asarray(
        coeff, dtype=np.uint8
    )
    o, k = matrix.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    n = data.shape[-1]
    pad = (-n) % 4
    x8 = F.pad(data, (0, pad)) if pad else data.contiguous()
    words = x8.view(torch.int32)  # [..., k, N4]
    acc: list[torch.Tensor | None] = [None] * o
    for d in range(k):
        col = [int(c) for c in matrix[:, d]]
        top = max(c.bit_length() for c in col)
        x = words[..., d, :]
        for b in range(top):
            if b:
                x = _xtime_i32(x)
            for i in range(o):
                if col[i] >> b & 1:
                    acc[i] = x if acc[i] is None else acc[i] ^ x
    zero = torch.zeros_like(words[..., 0, :])
    out = torch.stack([a if a is not None else zero for a in acc], dim=-2)
    return out.view(torch.uint8)[..., :n]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None  # guarded-by: _lib_lock


def width_table(max_width_fn) -> list[int]:
    """``max_width_fn(o, form)`` for every output count and form: what a
    built library's ``*_max_width`` must give as :func:`max_width`
    does."""
    return [max_width_fn(o, f) for f in (FORM_RUNTIME, FORM_RS10X4)
            for o in range(1, MAX_OUT + 1)]


def library():
    """The built kernel library (``nvcc`` at first use), with its C
    signatures declared and its limits checked against this module's."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("gf_swar")  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
            lib.gf_swar_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.gf_swar_launch.restype = ctypes.c_int
            for fn in ("gf_swar_batch_fastest_launch",
                       "gf_swar_fusedv_launch"):
                getattr(lib, fn).argtypes = lib.gf_swar_launch.argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.gf_swar_error_string.argtypes = [ctypes.c_int]
            lib.gf_swar_error_string.restype = ctypes.c_char_p
            for fn in ("gf_swar_coeff_bytes", "gf_swar_max_out",
                       "gf_swar_max_in"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ctypes.c_int
            lib.gf_swar_max_width.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.gf_swar_max_width.restype = ctypes.c_int
            expect = (MAX_IN * 8 * 2 + MAX_IN, MAX_OUT, MAX_IN,
                      width_table(max_width))
            got = (lib.gf_swar_coeff_bytes(), lib.gf_swar_max_out(),
                   lib.gf_swar_max_in(), width_table(lib.gf_swar_max_width))
            if got != expect:
                raise RuntimeError(
                    f"gf_swar library limits {got} != wrapper's {expect}"
                )
            _lib = lib
        return _lib


def launch(coeff: SwarCoeff, data: torch.Tensor, out: torch.Tensor,
           stream: torch.cuda.Stream | None = None, *,
           width: int | None = None) -> None:
    """Launch the kernel: out[B, o, N] = coeff ∘GF data[B, k, N] on CUDA
    uint8 tensors, contiguous, N a multiple of 16. Enqueues on
    ``stream`` (default: the current stream) and does not synchronise.
    ``width`` (column words a thread) is :func:`launch_plan`'s unless
    given, for timing one W against another. Raises on any tensor the
    kernel does not take and on a launch the runtime refuses."""
    o, k = coeff.shape
    if data.device.type != "cuda" or out.device != data.device:
        raise ValueError("launch needs CUDA tensors on one device")
    if data.dtype != torch.uint8 or out.dtype != torch.uint8:
        raise ValueError("launch needs uint8 tensors")
    if data.dim() != 3 or out.dim() != 3:
        raise ValueError("launch needs [B, rows, N] tensors")
    batch, k2, n = data.shape
    if k2 != k or tuple(out.shape) != (batch, o, n):
        raise ValueError(
            f"shapes {tuple(data.shape)} -> {tuple(out.shape)} do not fit "
            f"a [{o}, {k}] matrix"
        )
    if n % QUANTUM or not data.is_contiguous() or not out.is_contiguous():
        raise ValueError(
            f"launch needs contiguous rows of a multiple of {QUANTUM} bytes"
        )
    if not (1 <= batch <= MAX_BATCH):
        raise ValueError(f"batch {batch} outside 1..{MAX_BATCH}")
    form = FORM_RS10X4 if coeff.rs10x4 else FORM_RUNTIME
    if width is not None and not 1 <= width <= max_width(o, form):
        raise ValueError(f"width {width} outside 1..{max_width(o, form)} "
                         f"for {o} outputs in form {form}")
    if n == 0:
        return  # nothing to compute, and no launch to count
    n16 = n // QUANTUM
    w, form = launch_plan(coeff, n16, batch, sm_count(data.device.index))
    w = width or w
    if stream is None:
        stream = torch.cuda.current_stream(data.device)
    rc = library().gf_swar_launch(
        data.data_ptr(), out.data_ptr(), o, k, n16, batch, coeff.packed, w,
        form, data.device.index, stream.cuda_stream,
    )
    build.check_rc(library().gf_swar_error_string, rc, "gf_swar")
    LAUNCHES.add()
    if form == FORM_RS10X4:
        RS10X4_LAUNCHES.add()


def gf_matmul(coeff: SwarCoeff | np.ndarray,
              data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor.

    A CPU tensor goes through :func:`gf_matmul_plain`. A CUDA tensor
    launches the kernel on the current stream, the one that ordered the
    writes of ``data``: leading dims fold into the kernel's batch, a
    ragged N is zero-padded to the 16-byte quantum and the result sliced
    back (the reference pads to its tile the same way,
    gf_kernel.py:477-485). Any other device raises."""
    if not isinstance(coeff, SwarCoeff):
        coeff = coeff_from_reference(coeff)
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu, not {data.device}")
    o, k = coeff.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be uint8 [..., {k}, N], got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    *lead, _, n = data.shape
    batch = int(np.prod(lead)) if lead else 1
    pad = (-n) % QUANTUM
    x = F.pad(data, (0, pad)) if pad else data.contiguous()
    x = x.reshape(batch, k, n + pad)
    out = torch.empty((batch, o, n + pad), dtype=torch.uint8,
                      device=data.device)
    launch(coeff, x, out)
    return out.reshape(*lead, o, n + pad)[..., :n]


# ---------------------------------------------------------------------------
# Kernels of other libraries that take u8 rows as they lie
# ---------------------------------------------------------------------------


class RowsKernel:
    """A kernel library whose launcher takes u8 rows by batch and row
    stride, any width, and this module's coefficient struct:
    ``<name>_launch(in, out, o, k, n, *extra, batch, in_bs, in_rs, out_bs,
    out_rs, coeff, device, stream)`` (gf_swar_u8, gf_vpu, gf_fused_u8).
    Built at first use; counts its launches in ``launches``. ``forms``:
    the library instantiates this module's coefficient forms and widths,
    and its ``<name>_max_width`` must agree with :func:`max_width`."""

    def __init__(self, name: str, extra_argtypes=(), forms: bool = False):
        self.name = name
        self.forms = forms
        self.launches = LaunchCounter()
        self._argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, *extra_argtypes, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        self._lock = threading.Lock()
        self._lib = None  # guarded-by: self._lock

    def library(self):
        """The built library (``nvcc`` at first use), its argument struct
        checked against this module's packing."""
        with self._lock:
            if self._lib is None:
                lib = build.declare(build.load(self.name), {  # weedcheck: ignore[lock-held-across-blocking]: first use builds the kernel once; later callers must wait for the declared library
                    f"{self.name}_launch": (self._argtypes, ctypes.c_int),
                    f"{self.name}_error_string": ([ctypes.c_int],
                                                  ctypes.c_char_p),
                    f"{self.name}_coeff_bytes": ([], ctypes.c_int),
                })
                got = getattr(lib, f"{self.name}_coeff_bytes")()
                if got != MAX_IN * 8 * 2 + MAX_IN:
                    raise RuntimeError(
                        f"{self.name} takes {got} coefficient bytes, "
                        f"gf_swar packs {MAX_IN * 8 * 2 + MAX_IN}"
                    )
                if self.forms:
                    build.declare(lib, {f"{self.name}_max_width": (
                        [ctypes.c_int, ctypes.c_int], ctypes.c_int)})
                    widths = width_table(getattr(lib, f"{self.name}_max_width"))
                    if widths != width_table(max_width):
                        raise RuntimeError(
                            f"{self.name} library widths {widths} != "
                            f"wrapper's {width_table(max_width)}"
                        )
                self._lib = lib
            return self._lib

    def __call__(self, coeff: SwarCoeff, data: torch.Tensor,
                 *extra) -> torch.Tensor:
        """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 CUDA
        tensor whose rows may be strided and N ragged, launched on the
        current stream; ``extra`` are the launcher's own arguments."""
        if data.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda, not {data.device}")
        o, k = coeff.shape
        if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
            raise ValueError(
                f"data must be uint8 [..., {k}, N], got {data.dtype} "
                f"{tuple(data.shape)}"
            )
        *lead, _, n = data.shape
        x = build.rows3d(data)
        batch = x.shape[0]
        if not 1 <= batch <= MAX_BATCH:
            raise ValueError(f"batch {batch} outside 1..{MAX_BATCH}")
        out = torch.empty((batch, o, n), dtype=torch.uint8,
                          device=data.device)
        if n:
            lib = self.library()
            rc = getattr(lib, f"{self.name}_launch")(
                x.data_ptr(), out.data_ptr(), o, k, n, *extra, batch,
                x.stride(0), x.stride(1), out.stride(0), out.stride(1),
                coeff.packed, data.device.index,
                torch.cuda.current_stream(data.device).cuda_stream,
            )
            build.check_rc(getattr(lib, f"{self.name}_error_string"), rc,
                           self.name)
            self.launches.add()
        return out.reshape(*lead, o, n)


# ---------------------------------------------------------------------------
# Launch forms over u32 words of V volumes
# ---------------------------------------------------------------------------


def _words_form(fn: str, counter: LaunchCounter,
                coeff: SwarCoeff | np.ndarray, words: torch.Tensor,
                per_volume_threads: bool) -> torch.Tensor:
    """out[V, o, n4] = coeff ∘GF words[V, k, n4] through launcher ``fn``
    for int32 or uint32 words; the output has the input's dtype. A CPU
    tensor goes through :func:`gf_matmul_plain` on the bytes.
    ``per_volume_threads``: the launcher gives each volume its own
    threads (else one thread walks all volumes of its words)."""
    if not isinstance(coeff, SwarCoeff):
        coeff = coeff_from_reference(coeff)
    o, k = coeff.shape
    if (words.dtype not in (torch.int32, torch.uint32) or words.dim() != 3
            or words.shape[1] != k):
        raise ValueError(
            f"words must be int32 or uint32 [V, {k}, n4], got {words.dtype} "
            f"{tuple(words.shape)}"
        )
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cuda or cpu, not {words.device}")
    volumes, _, n4 = words.shape
    threads_over = volumes if per_volume_threads else 1
    pad = (-n4) % (QUANTUM // 4)
    x = F.pad(words.view(torch.int32), (0, pad)) if pad else (
        words.view(torch.int32).contiguous())
    if words.device.type == "cpu":
        out = gf_matmul_plain(coeff, x.view(torch.uint8)).view(torch.int32)
        return out[..., :n4].view(words.dtype)
    out = torch.empty((volumes, o, n4 + pad), dtype=torch.int32,
                      device=words.device)
    if n4:
        n16 = (n4 + pad) * 4 // QUANTUM
        width, form = launch_plan(coeff, n16, threads_over,
                                  sm_count(words.device.index))
        rc = getattr(library(), fn)(
            x.data_ptr(), out.data_ptr(), o, k, n16, volumes, coeff.packed,
            width, form, words.device.index,
            torch.cuda.current_stream(words.device).cuda_stream,
        )
        build.check_rc(library().gf_swar_error_string, rc, fn)
        counter.add()
        if form == FORM_RS10X4:
            RS10X4_LAUNCHES.add()
    return out[..., :n4].view(words.dtype)


def gf_matmul_batch_fastest(coeff: SwarCoeff | np.ndarray,
                            words: torch.Tensor) -> torch.Tensor:
    """out[V, o, n4] = coeff ∘GF words[V, k, n4] for u32 words, launched
    with the batch as the fastest block index."""
    return _words_form("gf_swar_batch_fastest_launch",
                       BATCH_FASTEST_LAUNCHES, coeff, words, True)


def gf_matmul_fusedv(coeff: SwarCoeff | np.ndarray,
                     words: torch.Tensor) -> torch.Tensor:
    """out[V, o, n4] = coeff ∘GF words[V, k, n4] for u32 words, one
    thread walking all V volumes of its column word."""
    return _words_form("gf_swar_fusedv_launch", FUSEDV_LAUNCHES, coeff,
                       words, False)
