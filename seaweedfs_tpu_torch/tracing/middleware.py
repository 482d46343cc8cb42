"""Server-side tracing middleware shared by master, volume, filer, and
the S3 gateway.

`instrument(router, component)` does three things:

* prepends the debug plane (ahead of existing routes, so catch-all
  data-plane patterns don't shadow it — the same reserved-path
  convention as the filer's `/__kv/`): `GET /debug/traces` (the
  process-wide span ring as JSON; `?traceId=` filters one trace,
  `?limit=` the tail), `GET /debug/slow` (the slow-request ledger),
  and the profiling endpoints `GET /debug/stacks` / `GET /debug/vars`
  (telemetry/debug.py) plus the sampling profiler
  `GET /debug/profile?seconds=N` (telemetry/profile.py);
* wraps the router so every dispatch runs under a server span whose
  trace context comes from the inbound `traceparent` header (a new root
  trace when absent), finished when the response — including a streamed
  body — completes;
* offers every finished request span to the slow-request ledger
  (telemetry/slow.py), so the N slowest requests stay inspectable with
  their trace ids and fault tags.

Handlers refine the provisional `METHOD /path` op via
`tracing.set_op(...)`; the data plane MUST (fid/object paths are
unbounded label values for the span histogram otherwise).

The port's copy of ``seaweedfs_tpu/tracing/middleware.py``; the port's
master and volume server route through it.
"""

from __future__ import annotations

from ..telemetry import debug as telemetry_debug
from ..telemetry import profile as telemetry_profile
from ..telemetry.slow import LEDGER
from ..util.http import Request, Response, Router
from . import recorder
from .span import Span, extract, set_current


def _finish(span: Span, status: int | None = None) -> None:
    """Finish a request span and offer it to the slow ledger exactly
    once (streamed responses may race close() with exhaustion)."""
    if span._recorded:
        return
    recorder.finish(span, status=status)
    LEDGER.offer_span(span)


class _SpanStream:
    """Wraps a streamed response body so each chunk is produced with the
    request span active (nested fetches keep propagating the trace) and
    the span is finished when the stream ends, errors, or is closed —
    a streamed response's duration covers the full write-out, not just
    the handler that returned the iterator."""

    def __init__(self, inner, span: Span):
        self._inner = iter(inner)
        self._span = span

    def __iter__(self) -> "_SpanStream":
        return self

    def __next__(self) -> bytes:
        prev = set_current(self._span)
        try:
            return next(self._inner)
        except StopIteration:
            _finish(self._span)
            raise
        except Exception:
            _finish(self._span, status=500)
            raise
        finally:
            set_current(prev)

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close:
            close()
        _finish(self._span)


class TracedRouter:
    """Router wrapper: extract traceparent, dispatch under a server
    span, finish the span with the response."""

    def __init__(self, inner: Router, component: str):
        self.inner = inner
        self.component = component

    def dispatch(self, req: Request) -> Response:
        parent = extract(req.headers)
        span = Span(
            self.component,
            f"{req.method} {req.path}",
            trace_id=parent[0] if parent else None,
            parent_id=parent[1] if parent else "",
        )
        conn = getattr(req, "connection", None)
        if conn is not None:
            try:
                peer = conn.getpeername()
                span.attrs["peer"] = f"{peer[0]}:{peer[1]}"
            except (OSError, IndexError):
                pass
        prev = set_current(span)
        try:
            resp = self.inner.dispatch(req)
        except Exception:
            _finish(span, status=500)
            raise
        finally:
            set_current(prev)
        span.status = resp.status
        if resp.stream is not None:
            resp.stream = _SpanStream(resp.stream, span)
        else:
            _finish(span)
        resp.headers.setdefault("X-Trace-Id", span.trace_id)
        return resp


def _h_debug_traces(req: Request) -> Response:
    tid = req.param("traceId") or req.param("trace_id")
    try:
        limit = int(req.param("limit", "0") or 0)
    except ValueError:
        limit = 0
    spans = recorder.RECORDER.spans(
        trace_id=tid or None, limit=limit
    )
    return Response.json({"spans": [s.to_dict() for s in spans]})


def instrument(router: Router, component: str) -> TracedRouter:
    """Wire tracing + the debug plane into one server; see module
    docstring."""
    router.add("GET", r"/debug/traces", _h_debug_traces, prepend=True)
    router.add(
        "GET", r"/debug/slow", telemetry_debug.handle_slow, prepend=True
    )
    router.add(
        "GET", r"/debug/stacks", telemetry_debug.handle_stacks,
        prepend=True,
    )
    router.add(
        "GET", r"/debug/vars", telemetry_debug.handle_vars, prepend=True
    )
    router.add(
        "GET", r"/debug/profile", telemetry_profile.handle_profile,
        prepend=True,
    )
    router.add(
        "GET", r"/debug/timeline", telemetry_debug.handle_timeline,
        prepend=True,
    )
    router.add(
        "GET", r"/debug/contention",
        telemetry_debug.handle_contention, prepend=True,
    )
    router.add(
        "GET", r"/debug/devices",
        telemetry_debug.handle_devices, prepend=True,
    )
    return TracedRouter(router, component)
