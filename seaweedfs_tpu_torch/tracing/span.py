"""W3C-traceparent trace context + the thread-local active span.

The port's copy of ``seaweedfs_tpu/tracing/span.py``. Dapper-style
(Sigelman et al., 2010) request tracing: every span carries (trace id,
span id, parent id); the context crosses HTTP hops as a ``traceparent``
header (``00-<trace32>-<span16>-01``, the W3C Trace Context wire
format), so one request renders as a single tree across servers.

The ACTIVE span is thread-local: a thread-per-request server's handler
thread's active span is exactly the request being served. Work handed to
another thread (the codec's host pool, the encoder's writer thread) must
carry the span explicitly via ``attach(span)`` or a ``parent=``
argument.
"""

from __future__ import annotations

import contextlib
import random
import re
import threading
import time

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def new_trace_id() -> str:
    return f"{random.getrandbits(128) or 1:032x}"


def new_span_id() -> str:
    return f"{random.getrandbits(64) or 1:016x}"


class Span:
    """One timed operation in a trace.

    `component` is the serving layer ("s3", "filer", "volume",
    "master", "codec", ...); `op` the operation within it
    ("PutObject", "write", "assign"). Middleware creates a span with a
    provisional `METHOD /path` op; handlers refine it via `set_op` so
    metric label cardinality stays bounded on the data plane.
    """

    def __init__(
        self,
        component: str,
        op: str,
        trace_id: str | None = None,
        parent_id: str = "",
    ):
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.component = component
        self.op = op
        self.start = time.time()
        self.duration = 0.0
        self.status = 0
        self.attrs: dict[str, object] = {}
        # monotonic origin for duration; wall `start` is for display
        self._t0 = time.perf_counter()
        self._recorded = False

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "component": self.component,
            "op": self.op,
            "start": self.start,
            "duration": self.duration,
            "status": self.status,
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:
        return (
            f"Span({self.component}.{self.op} trace={self.trace_id[:8]} "
            f"span={self.span_id[:8]} parent={self.parent_id[:8] or '-'})"
        )


def parse_traceparent(value: str) -> tuple[str, str] | None:
    """`00-<trace32>-<span16>-<flags>` → (trace_id, span_id); None for
    anything malformed or all-zero (the W3C invalid sentinel)."""
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


_tls = threading.local()


def current() -> Span | None:
    """The thread's active span, or None outside any traced request."""
    return getattr(_tls, "span", None)


def set_current(span: Span | None) -> Span | None:
    """Install `span` as the thread's active span; returns the previous
    one so callers can restore it."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    return prev


def set_op(op: str) -> None:
    """Refine the active span's operation name (no-op when untraced)."""
    sp = current()
    if sp is not None:
        sp.op = op


@contextlib.contextmanager
def attach(span: Span | None):
    """Run a block with `span` active — carries a request's context onto
    a worker thread (replication fan-out, codec host pool) where the
    thread-local would otherwise be empty."""
    prev = set_current(span)
    try:
        yield span
    finally:
        set_current(prev)


def extract(headers: dict) -> tuple[str, str] | None:
    """Pull (trace_id, parent span_id) out of request headers
    (case-insensitive, per RFC 9110)."""
    for k, v in headers.items():
        if k.lower() == TRACEPARENT_HEADER:
            return parse_traceparent(v)
    return None


def inject(headers: dict) -> dict:
    """Add the active span's traceparent to outbound request headers
    (no-op outside a traced request); returns `headers`."""
    sp = current()
    if sp is not None:
        headers.setdefault(TRACEPARENT_HEADER, sp.traceparent())
    return headers
