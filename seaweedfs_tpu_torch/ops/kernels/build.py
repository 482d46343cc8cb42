"""Build the port's CUDA sources into shared libraries at first use.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Nothing includes PyTorch's headers, so a build takes seconds.

Builds land in ``_build/`` beside this file (listed in ``.gitignore``),
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags: a changed source or header builds anew, an unchanged one
loads what is there. Several processes may build
at once (a test run with many workers): each compiles to a private
temporary name and ``os.replace``s it into place, so a reader never sees
a half-written library.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
# name -> (library path, seconds spent building, ptxas report) of the
# sources prebuild() compiled in this process
_built: dict[str, tuple[str, float, str]] = {}  # guarded-by: _lock
# name -> path, seconds spent building (0.0 when cached) and ptxas report
build_info: dict[str, dict] = {}  # guarded-by: _lock


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the CUDA
    toolkit's standard install location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use"
    )


def _source_key(src: str, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def compile_source(name: str) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless a library of the same content
    hash exists; returns (library path, build seconds, ptxas report)."""
    src = os.path.join(CSRC, name + ".cu")
    flags = ARCH_FLAGS + NVCC_FLAGS
    lib = os.path.join(BUILD_DIR, f"lib{name}-{_source_key(src, flags)}.so")
    log = lib[:-3] + ".log"
    if os.path.exists(lib):
        report = ""
        if os.path.exists(log):
            with open(log) as f:
                report = f.read()
        return lib, 0.0, report
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name} (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    with open(log + f".{os.getpid()}.tmp", "w") as f:
        f.write(report)
    os.replace(log + f".{os.getpid()}.tmp", log)
    os.replace(tmp, lib)
    return lib, seconds, report


def prebuild(names) -> None:
    """Compile every named source at once, one ``nvcc`` process each,
    so a first use of several kernels waits for the slowest build and
    not for their sum. Raises once every build has ended, with the
    errors of all that failed."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(compile_source, n) for n in names]
    failed = [f.exception() for f in futures if f.exception() is not None]
    if failed:
        raise RuntimeError("\n\n".join(str(e) for e in failed))
    results = [f.result() for f in futures]
    with _lock:
        _built.update(zip(names, results))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use
    in this process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, seconds, report = _built.get(name) or compile_source(name)  # weedcheck: ignore[lock-held-across-blocking]: the lock exists to serialize the one-time nvcc build; contenders must wait for the library
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
            build_info[name] = {
                "path": path, "seconds": seconds, "ptxas": report,
            }
        return lib


def declare(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Set ``argtypes`` and ``restype`` of each C function named in
    ``signatures`` (name -> (argtypes, restype)); returns ``lib``."""
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check_rc(error_string, rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code other than 0;
    ``error_string`` is the library's C function that names the code."""
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cuda error {rc})")


class LaunchCounter:
    """Number of kernel launches since the last ``reset()``: the proof
    that a run went through the kernel and not its plain version."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: self._lock

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def rows3d(t):
    """``t`` [..., rows, W] as the [B, rows, W] view the launchers take,
    leading dims folded into B: a view where the strides allow, a copy
    otherwise, and a copy whenever a row's bytes are not consecutive."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dim() == 2:
        return t.unsqueeze(0)
    if t.dim() == 3:
        return t
    return t.reshape(-1, *t.shape[-2:])
