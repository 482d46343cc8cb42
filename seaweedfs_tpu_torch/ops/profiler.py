"""Per-dispatch codec profiling.

The port's counterpart of ``seaweedfs_tpu/ops/profiler.py``. Every codec
dispatch (``ops/codec.py``) records (backend, coefficient shape, input
bytes, seconds) into:

* the ``seaweedfs_codec_dispatch_seconds{backend,shape}`` histogram and
  ``seaweedfs_codec_dispatch_bytes_total`` counter of the port's
  registry;
* the device ledger (``telemetry/devices.py``), which keeps the ``cuda``
  backend's dispatches on the card's row;
* a ``codec.encode(backend,oxk)`` tracing span, a child of the span
  that launched the dispatch;
* a bounded ring of :class:`Record` while collection is on
  (:func:`enabled`, or ``SEAWEEDFS_TPU_PROFILE=1`` for always-on).

Seconds are wall time including the wait for the result (for the
kernel: staging, H2D, launch and the D2H wait, not the time its handle
sat in a queue), so a transfer-bound dispatch shows up as a collapsed
GB/s number rather than hiding behind an asynchronous launch.

With :func:`annotate` on, each dispatch's launch runs inside
``torch.profiler.record_function("codec.encode(backend,oxk)")``, so a
``torch.profiler`` trace carries the named ranges.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from .. import tracing
from ..stats.metrics import REGISTRY
from ..telemetry import devices as devices_mod

_MAX_RECORDS = 1024

DISPATCH_SECONDS = REGISTRY.histogram(
    "seaweedfs_codec_dispatch_seconds",
    "GF codec dispatch wall seconds (incl. sync) by backend",
    labels=("backend", "shape"),
)
DISPATCH_BYTES = REGISTRY.counter(
    "seaweedfs_codec_dispatch_bytes_total",
    "Input bytes fed through the GF codec by backend",
    labels=("backend", "shape"),
)


@dataclass(frozen=True)
class Record:
    backend: str
    shape: str  # "oxk"
    in_bytes: int
    seconds: float

    @property
    def gbps(self) -> float:
        return self.in_bytes / max(self.seconds, 1e-12) / 1e9

    def __str__(self) -> str:
        return (
            f"{self.backend:>8} {self.shape:>6} "
            f"{self.in_bytes / 1e6:10.2f} MB {self.seconds * 1e3:9.3f} ms "
            f"{self.gbps:8.2f} GB/s"
        )


_lock = threading.Lock()
_records: deque[Record] = deque(maxlen=_MAX_RECORDS)  # guarded-by: _lock
_enabled = os.environ.get("SEAWEEDFS_TPU_PROFILE") == "1"
# when on, every dispatch's launch runs inside a torch.profiler
# record_function range, named as its span
_annotate = False


def is_enabled() -> bool:
    return _enabled


def annotate(on: bool = True) -> None:
    """Toggle ``torch.profiler.record_function`` ranges around codec
    dispatch launches, so a profile captured meanwhile carries named
    ``codec.encode(...)`` ranges."""
    global _annotate
    _annotate = on


@contextlib.contextmanager
def annotation(label: str):
    """``torch.profiler.record_function(label)`` while :func:`annotate`
    is on, else nothing."""
    if not _annotate:
        yield
        return
    import torch

    with torch.profiler.record_function(label):
        yield


@contextlib.contextmanager
def enabled():
    """Scope with profiling collection turned on."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


def record(backend: str, o: int, k: int, in_bytes: int,
           seconds: float, parent=None) -> None:
    """Record one dispatch. `parent` is the tracing span to attribute
    it to (default: the calling thread's active span) — inside a traced
    request the dispatch becomes a `codec.encode(backend,shape)` child
    span, so a slow kernel shows up IN the request tree that paid for
    it, not just in an aggregate histogram."""
    shape = f"{o}x{k}"
    DISPATCH_SECONDS.observe(seconds, backend, shape)
    DISPATCH_BYTES.inc(backend, shape, amount=in_bytes)
    # per-card attribution: a device dispatch (wall incl. sync) lands on
    # the device ledger's default row; host backends are ignored there
    devices_mod.LEDGER.on_codec_dispatch(backend, in_bytes, seconds)
    tracing.record_span(
        "codec", f"encode({backend},{shape})", seconds, parent=parent,
        attrs={
            "bytes": in_bytes,
            "gbps": round(in_bytes / max(seconds, 1e-12) / 1e9, 3),
        },
    )
    if _enabled:
        with _lock:
            _records.append(Record(backend, shape, in_bytes, seconds))


def records() -> list[Record]:
    with _lock:
        return list(_records)


def clear() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def timed(backend: str, o: int, k: int, in_bytes: int):
    """Time one dispatch; always feeds the stats family, and the ring
    buffer too when profiling is on. With :func:`annotate` on, the
    scope also carries a ``torch.profiler`` range."""
    t0 = time.perf_counter()
    try:
        with annotation(f"codec.encode({backend},{o}x{k})"):
            yield
    finally:
        record(backend, o, k, in_bytes, time.perf_counter() - t0)
