"""Bounded in-process span recorder + per-component/op latency family.

The port's copy of ``seaweedfs_tpu/tracing/recorder.py``. Finished spans
land in one process-wide ring buffer (newest last) and feed the
``seaweedfs_trace_span_seconds`` histogram of the port's registry, so
span latency shows next to the codec's counters. The ring is the Dapper
"recent traces" store scaled down to one process: bounded memory, no
sampling daemon, always on.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from ..stats.metrics import REGISTRY
from .span import Span, current, set_current

SPAN_SECONDS = REGISTRY.histogram(
    "seaweedfs_trace_span_seconds",
    "Traced span wall seconds by component and operation.",
    ("component", "op"),
)
SPAN_ERRORS = REGISTRY.counter(
    "seaweedfs_request_errors_total",
    "Traced requests finished with an error status, by component "
    "and status class.",
    ("component", "class"),
)

_CAPACITY = 4096


class SpanRecorder:
    """Ring buffer of finished spans."""

    def __init__(self, capacity: int = _CAPACITY):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(  # guarded-by: self._lock
            maxlen=capacity
        )

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(
        self, trace_id: str | None = None, limit: int = 0
    ) -> list[Span]:
        """Snapshot, oldest first; optionally one trace / last `limit`."""
        with self._lock:
            out = list(self._spans)
        if trace_id:
            out = [s for s in out if s.trace_id == trace_id]
        if limit > 0:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


RECORDER = SpanRecorder()


def finish(span: Span, status: int | None = None) -> None:
    """Close a span: compute its duration, feed the histogram, append to
    the ring. Idempotent — streamed responses may race close() with
    exhaustion."""
    if span._recorded:
        return
    span._recorded = True
    if status is not None:
        span.status = status
    span.duration = time.perf_counter() - span._t0
    SPAN_SECONDS.observe(span.duration, span.component, span.op)
    if span.status >= 500:
        SPAN_ERRORS.inc(span.component, "5xx")
    elif span.status >= 400:
        SPAN_ERRORS.inc(span.component, "4xx")
    RECORDER.add(span)


def record_span(
    component: str,
    op: str,
    seconds: float,
    parent: Span | None = None,
    attrs: dict | None = None,
) -> Span | None:
    """Record an already-timed operation as a child of `parent`
    (default: the thread's active span). Returns None — and records
    nothing — when there is no parent: a codec dispatch outside any
    traced request has no tree to hang from (its latency is still on
    `seaweedfs_codec_dispatch_seconds`)."""
    if parent is None:
        parent = current()
    if parent is None:
        return None
    span = Span(
        component, op,
        trace_id=parent.trace_id, parent_id=parent.span_id,
    )
    # constructs a DISPLAY epoch (span start for rendering), not a
    # duration — `seconds` was measured on a monotonic clock upstream
    span.start = time.time() - seconds  # weedcheck: ignore[wall-clock-duration]
    span.duration = seconds
    span._recorded = True
    if attrs:
        span.attrs.update(attrs)
    SPAN_SECONDS.observe(seconds, component, op)
    RECORDER.add(span)
    return span


@contextlib.contextmanager
def start_span(
    component: str, op: str, parent: Span | None = None
):
    """Open a span (child of `parent` or of the thread's active span),
    make it active for the block, record it on exit."""
    if parent is None:
        parent = current()
    span = Span(
        component, op,
        trace_id=parent.trace_id if parent else None,
        parent_id=parent.span_id if parent else "",
    )
    prev = set_current(span)
    try:
        yield span
    except Exception:
        span.status = 500
        raise
    finally:
        set_current(prev)
        finish(span)
