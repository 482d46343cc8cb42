"""Phase-level timing for multi-stage hot paths (the EC file pipeline).

The port's counterpart of ``seaweedfs_tpu/telemetry/phases.py``. A
:class:`PhaseTimer` is threaded through a pipeline and accumulates busy
seconds (and bytes) per named phase (read / stage / h2d / codec / write
/ flush for the EC encoder) across all of the pipeline's threads, then
reports the decomposition three ways at ``finish()``:

* tracing child spans — one ``phase.<op>.<name>`` span per phase under
  the span that was active where the timer was made;
* the ``seaweedfs_phase_seconds{op,phase}`` histogram of the port's
  registry (``stats/metrics.py``);
* a JSON-able summary dict, which :func:`summarize_line` and
  :func:`render_waterfall` print.

Phases overlap in time (the encoder reads slab N+2 while encoding N+1
and writing N), so the per-phase totals are BUSY time and may sum past
wall clock; the waterfall prints both. All timing is
``time.perf_counter()``.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..stats.metrics import REGISTRY
from ..tracing import recorder
from ..tracing import span as span_mod

# op and phase are code-chosen names (ec.encode x read/stage/...):
# bounded label cardinality by construction
PHASE_SECONDS = REGISTRY.histogram(
    "seaweedfs_phase_seconds",
    "Busy seconds per pipeline phase of a multi-stage operation.",
    ("op", "phase"),
)


class PhaseTimer:
    """Accumulates busy seconds (and bytes) per named phase of one
    operation; thread-safe — pipeline stages time themselves from
    their own threads."""

    def __init__(self, op: str, parent_span=None):
        self.op = op
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}  # guarded-by: self._lock
        self._counts: dict[str, int] = {}  # guarded-by: self._lock
        self._bytes: dict[str, int] = {}  # guarded-by: self._lock
        self._notes: dict[str, object] = {}  # guarded-by: self._lock
        self._t0 = time.perf_counter()
        self._wall: float | None = None  # guarded-by: self._lock
        # capture the creating request's span NOW: finish() may run
        # after the handler returned, or on another thread
        if parent_span is None:
            parent_span = span_mod.current()
        self._parent_span = parent_span

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

    def wall(self) -> float:
        """Seconds from construction to finish() (or to now)."""
        with self._lock:
            if self._wall is not None:
                return self._wall
        return time.perf_counter() - self._t0

    def totals(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def summary(self) -> dict:
        """JSON-able ``{op, wall_seconds, phases: {name: {seconds,
        count, bytes}}, notes}`` as it stands (wall clock to now until
        ``finish()``); exports nothing."""
        wall = self.wall()
        with self._lock:
            out = {
                "op": self.op,
                "wall_seconds": round(wall, 6),
                "phases": {
                    name: {
                        "seconds": round(secs, 6),
                        "count": self._counts.get(name, 0),
                        "bytes": self._bytes.get(name, 0),
                    }
                    for name, secs in self._seconds.items()
                },
            }
            if self._notes:
                out["notes"] = dict(self._notes)
        return out

    def finish(self) -> dict:
        """Freeze the wall clock, export every phase as a tracing child
        span + a ``seaweedfs_phase_seconds`` observation, and return
        the summary dict. Safe to call once per timer."""
        with self._lock:
            if self._wall is None:
                self._wall = time.perf_counter() - self._t0
        out = self.summary()
        for name, info in out["phases"].items():
            PHASE_SECONDS.observe(info["seconds"], self.op, name)
            recorder.record_span(
                "phase",
                f"{self.op}.{name}",
                info["seconds"],
                parent=self._parent_span,
                attrs={
                    "count": info["count"],
                    "bytes": info["bytes"],
                },
            )
        return out


def summarize_line(summary: dict) -> str:
    """One compact phase line from a finish() summary, for shell
    output: ``phases read=0.012s stage=0.003s ... (wall 0.050s,
    coverage 96%)``."""
    wall = summary.get("wall_seconds") or 0.0
    phases = summary.get("phases") or {}
    parts = [
        f"{name}={info['seconds']:.3f}s"
        for name, info in sorted(
            phases.items(), key=lambda kv: -kv[1]["seconds"]
        )
    ]
    busy = sum(info["seconds"] for info in phases.values())
    cov = f", coverage {100 * busy / wall:.0f}%" if wall > 0 else ""
    return (
        f"phases {' '.join(parts) or '-'} "
        f"(wall {wall:.3f}s{cov})"
    )


def render_waterfall(summary: dict) -> str:
    """Multi-line waterfall report from a finish() summary: one bar
    per phase scaled to wall time, with per-phase GB/s where bytes
    were recorded. Phases overlap across pipeline threads, so bars
    are busy-time shares and may sum past 100%."""
    wall = summary.get("wall_seconds") or 0.0
    phases = summary.get("phases") or {}
    lines = [f"{summary.get('op', '?')} waterfall "
             f"(wall {wall:.3f}s; busy time per phase, overlapped):"]
    width = 32
    for name, info in sorted(
        phases.items(), key=lambda kv: -kv[1]["seconds"]
    ):
        secs = info["seconds"]
        frac = secs / wall if wall > 0 else 0.0
        bar = "#" * max(1, min(width, round(frac * width)))
        gbps = (
            f" {info['bytes'] / secs / 1e9:.3f} GB/s"
            if info.get("bytes") and secs > 0
            else ""
        )
        lines.append(
            f"  {name:12} {bar:<{width}} {secs:8.3f}s "
            f"{100 * frac:5.1f}%{gbps}"
        )
    busy = sum(info["seconds"] for info in phases.values())
    if wall > 0:
        lines.append(
            f"  {'(accounted)':12} {busy:.3f}s busy / {wall:.3f}s wall "
            f"= {100 * busy / wall:.0f}%"
        )
    return "\n".join(lines)
