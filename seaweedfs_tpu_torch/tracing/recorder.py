"""Bounded in-process span recorder + per-component/op latency family.

The port's copy of ``seaweedfs_tpu/tracing/recorder.py``. Finished spans
land in one process-wide ring buffer (newest last) and feed the
``seaweedfs_trace_span_seconds`` histogram of the port's registry, so
span latency shows next to the codec's counters. The ring is the Dapper
"recent traces" store scaled down to one process: bounded memory, no
sampling daemon, always on.

One difference: :class:`RequestTally`. The families above are keyed by
component, so every server of one role in a process adds to the same
counts; each server's tracing middleware also keeps a tally of the
requests that server answered, which its telemetry snapshot reads.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from ..stats.metrics import REGISTRY, Histogram
from ..telemetry.slow import WindowSlow
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


def status_class(status: int) -> str | None:
    """``5xx``, ``4xx`` or None: the error family's class label."""
    if status >= 500:
        return "5xx"
    if status >= 400:
        return "4xx"
    return None


class RequestTally:
    """The request spans ONE server answered: how many, their 4xx and
    5xx counts, and the latency buckets (the span family's bounds, in a
    histogram no registry exposes) of those that were timed. Fed by
    that server's tracing middleware beside the process-wide families;
    read by its telemetry collector, so each server of an in-process
    fleet reports its own requests, as a server in its own process
    does. ``slow`` keeps its slowest timed answers of the window, which
    its collector stamps at each collect."""

    def __init__(self):
        self.seconds = Histogram(
            SPAN_SECONDS.name, SPAN_SECONDS.help
        )
        # the slowest timed answers of the collector's window
        self.slow = WindowSlow()
        self._lock = threading.Lock()
        self._total = 0  # guarded-by: self._lock
        self._classes = {"4xx": 0, "5xx": 0}  # guarded-by: self._lock

    def observe(self, seconds: float | None, status: int,
                span: Span | None = None) -> None:
        """One answered request; ``seconds`` None leaves its duration
        out of the latency buckets (a stream, a bulk job) and out of
        ``slow``, which gets ``span`` otherwise."""
        if seconds is not None:
            self.seconds.observe(seconds)
            if span is not None:
                self.slow.offer_span(span)
        cls = status_class(status)
        with self._lock:
            self._total += 1
            if cls is not None:
                self._classes[cls] += 1

    def counts(self) -> tuple[int, dict[str, int]]:
        """(requests answered, their 4xx and 5xx by class) so far."""
        with self._lock:
            return self._total, dict(self._classes)


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
    cls = status_class(span.status)
    if cls is not None:
        SPAN_ERRORS.inc(span.component, cls)
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
