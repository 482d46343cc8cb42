"""Phase-level timing for multi-stage hot paths (the EC file pipeline).

The port's counterpart of ``seaweedfs_tpu/telemetry/phases.py``, reduced
to what it accumulates: a :class:`PhaseTimer` is threaded through a
pipeline and sums busy seconds (and bytes) per named phase (read /
stage / h2d / codec / write / flush for the EC encoder) across all of
the pipeline's threads. Phases overlap in time, so the totals are busy
time and may sum past wall clock. The reference's tracing spans and
Prometheus histogram come with the port of the telemetry plane.
"""

from __future__ import annotations

import contextlib
import threading
import time


class PhaseTimer:
    """Accumulates busy seconds (and bytes) per named phase of one
    operation; thread-safe — pipeline stages time themselves from
    their own threads."""

    def __init__(self, op: str):
        self.op = op
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}  # guarded-by: self._lock
        self._counts: dict[str, int] = {}  # guarded-by: self._lock
        self._bytes: dict[str, int] = {}  # guarded-by: self._lock
        self._notes: dict[str, object] = {}  # guarded-by: self._lock
        self._t0 = time.perf_counter()

    def add(self, phase: str, seconds: float, n_bytes: int = 0) -> None:
        with self._lock:
            self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds
            self._counts[phase] = self._counts.get(phase, 0) + 1
            if n_bytes:
                self._bytes[phase] = self._bytes.get(phase, 0) + n_bytes

    def note(self, key: str, value) -> None:
        """Attach one configuration fact (chosen batch bytes, pipeline
        depth, ...) to the summary."""
        with self._lock:
            self._notes[key] = value

    @contextlib.contextmanager
    def phase(self, name: str, n_bytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, n_bytes)

    def summary(self) -> dict:
        """JSON-able ``{op, wall_seconds, phases: {name: {seconds,
        count, bytes}}, notes}``."""
        with self._lock:
            out = {
                "op": self.op,
                "wall_seconds": time.perf_counter() - self._t0,
                "phases": {
                    name: {
                        "seconds": secs,
                        "count": self._counts.get(name, 0),
                        "bytes": self._bytes.get(name, 0),
                    }
                    for name, secs in self._seconds.items()
                },
            }
            if self._notes:
                out["notes"] = dict(self._notes)
        return out
