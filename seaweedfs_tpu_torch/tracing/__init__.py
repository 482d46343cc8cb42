"""End-to-end tracing of the port (Dapper-style): the W3C
``traceparent`` context, the thread-local active span, a bounded
in-process span recorder with the ``seaweedfs_trace_span_seconds``
histogram, and span-tree rendering.

The port's copy of ``seaweedfs_tpu/tracing``; the server middleware is
``tracing/middleware.py``, which the port's master and volume server
route through. Codec dispatches
(``ops/profiler.py``) and pipeline phases (``telemetry/phases.py``)
record here as children of the span that launched them.
"""

from .recorder import (  # noqa: F401
    RECORDER,
    SPAN_SECONDS,
    SpanRecorder,
    finish,
    record_span,
    start_span,
)
from .render import render_tree  # noqa: F401
from .span import (  # noqa: F401
    TRACEPARENT_HEADER,
    Span,
    attach,
    current,
    extract,
    inject,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    set_current,
    set_op,
)
