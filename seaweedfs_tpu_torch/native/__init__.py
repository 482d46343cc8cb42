"""ctypes binding of the port's host codec (``gf256.cc`` beside this file).

The port's counterpart of ``seaweedfs_tpu/native/__init__.py``: the same
``gf_matmul`` and ``crc32c``, from the port's own copy of the source.
The host route of ``ops/codec.RSCodec`` (dispatches under its size
floor) and the needle checksum (``storage/needle.crc32c``) run here.

The library builds at first use with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``_build/`` beside this file (listed in ``.gitignore``),
keyed by a hash of the source and the flags. Each build compiles to a
private temporary name and ``os.replace``s it into place, so processes
and threads that build at once never load a half-written library, and
no lock is held while the compiler runs. A failed build raises
:class:`NativeUnavailable`: nothing falls back to numpy or to the plain
PyTorch version in its place.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "gf256.cc")
BUILD_DIR = os.path.join(HERE, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # guarded-by: _lock


class NativeUnavailable(RuntimeError):
    """The host codec could not be built or loaded."""


def compile_library(build_dir: str | None = None,
                    cxx: str | None = None) -> str:
    """Path of the built library, compiling ``gf256.cc`` with ``cxx``
    (default :data:`CXX`) unless a library of the same source and flags
    is already in ``build_dir`` (default :data:`BUILD_DIR`). Raises
    :class:`NativeUnavailable` when the compiler is missing or fails."""
    build_dir = build_dir or BUILD_DIR
    cxx = cxx or CXX
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join(CXX_FLAGS).encode())
    lib = os.path.join(build_dir, f"libgf256-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    compiler = shutil.which(cxx)
    if compiler is None:
        raise NativeUnavailable(
            f"cannot build the host codec: compiler {cxx!r} not found"
        )
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeUnavailable(
            f"cannot build the host codec (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.gf_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.gf_matmul.restype = None
    lib.crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
    lib.crc32c.restype = ctypes.c_uint32
    # fill the GF tables once here, before two host-pool threads could
    # race to do it in their first gf_matmul (a zero-width product)
    one = np.zeros(1, dtype=np.uint8)
    lib.gf_matmul(one.ctypes.data, 1, 1, one.ctypes.data, one.ctypes.data, 0)
    return lib


def library() -> ctypes.CDLL:
    """The loaded host codec, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    path = compile_library()  # outside the lock: the build is atomic
    with _lock:
        if _lib is None:
            _lib = _open(path)
        return _lib


def available() -> bool:
    """Whether the host codec builds and loads here: True when
    :func:`library` loads, False when it raises :class:`NativeUnavailable`.

    It only reports (a bench names its baseline's presence with it). No
    path of the port consults it to route around the host codec or the
    card: a caller that needs the codec calls :func:`library` and a
    failed build raises there, with nothing in its place."""
    try:
        library()
        return True
    except NativeUnavailable:
        return False


def _as_u8(data) -> np.ndarray:
    """A C-contiguous uint8 view of ``data`` (bytes, bytearray,
    memoryview or array), copying only an array that is not one."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def gf_matmul(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[o, n] = coeff[o, k] ∘GF data[k, n] on the host CPU (AVX2)."""
    lib = library()
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if coeff.ndim != 2 or data.ndim != 2 or coeff.shape[1] != data.shape[0]:
        raise ValueError(
            f"gf_matmul needs [o, k] and [k, n], got {coeff.shape} and "
            f"{data.shape}"
        )
    o, k = coeff.shape
    n = data.shape[1]
    out = np.empty((o, n), dtype=np.uint8)
    lib.gf_matmul(coeff.ctypes.data, o, k, data.ctypes.data,
                  out.ctypes.data, n)
    return out


def crc32c(data, value: int = 0) -> int:
    """CRC32-Castagnoli of ``data`` continued from ``value`` (the
    ``google_crc32c.extend`` semantics), SSE4.2 when present."""
    lib = library()
    buf = _as_u8(data)
    return lib.crc32c(value, buf.ctypes.data, buf.size)
