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

The port's copy of ``seaweedfs_tpu/tracing/middleware.py``; every port
server routes through it. One difference: each `TracedRouter` also
keeps its server's own `RequestTally` (`.tally`), fed with every
request span it finishes, for that server's telemetry snapshot, with
its slowest timed answers of the telemetry window (`.tally.slow`, read
by `slow_answers` for each server of an in-process fleet). A request to a
route of `UNTIMED` counts in the tally's requests and errors but leaves
its duration out of the tally's latency and slow answers.
"""

from __future__ import annotations

import weakref

from ..telemetry import debug as telemetry_debug
from ..telemetry import profile as telemetry_profile
from ..telemetry.slow import LEDGER
from ..util.http import Request, Response, Router
from . import recorder
from .span import Span, extract, set_current

# (component, method, path) of the routes whose time is not an answer's:
# streams open as long as their connection (the heartbeat stream, the
# cluster watch, the filer's event subscription) and bulk jobs whose
# time grows with the bytes they move (EC generate, rebuild, copy and
# decode, vacuum, volume copy, tier moves, the tail). Upstream serves
# them as gRPC streams and admin calls, outside its HTTP request
# latency; here each counts in its server's requests and errors, and
# its duration stays out of that server's latency (the p99 objective).
UNTIMED = frozenset({
    ("master", "POST", "/heartbeat/stream"),
    ("master", "GET", "/cluster/watch"),
    ("master", "GET", "/vol/vacuum"),
    ("master", "POST", "/vol/vacuum"),
    ("filer", "GET", "/meta/events"),
    ("volume", "POST", "/admin/vacuum/compact"),
    ("volume", "POST", "/admin/ec/generate"),
    ("volume", "POST", "/admin/ec/generate_batch"),
    ("volume", "POST", "/admin/ec/rebuild"),
    ("volume", "POST", "/admin/ec/copy"),
    ("volume", "GET", "/admin/ec/download"),
    ("volume", "POST", "/admin/ec/to_volume"),
    ("volume", "POST", "/admin/volume_copy"),
    ("volume", "POST", "/admin/tier/upload"),
    ("volume", "POST", "/admin/tier/download"),
    ("volume", "GET", "/admin/tail"),
})


def _finish(span: Span, tally: recorder.RequestTally, timed: bool,
            status: int | None = None) -> None:
    """Finish a request span, offer it to the slow ledger and count it
    in its server's tally exactly once (streamed responses may race
    close() with exhaustion); an untimed one's duration stays out of
    the tally's latency and slow answers."""
    if span._recorded:
        return
    recorder.finish(span, status=status)
    tally.observe(span.duration if timed else None, span.status, span)
    LEDGER.offer_span(span)


class _SpanStream:
    """Wraps a streamed response body so each chunk is produced with the
    request span active (nested fetches keep propagating the trace) and
    the span is finished when the stream ends, errors, or is closed —
    a streamed response's duration covers the full write-out, not just
    the handler that returned the iterator."""

    def __init__(self, inner, span: Span, tally: recorder.RequestTally,
                 timed: bool):
        self._inner = iter(inner)
        self._span = span
        self._tally = tally
        self._timed = timed

    def __iter__(self) -> "_SpanStream":
        return self

    def __next__(self) -> bytes:
        prev = set_current(self._span)
        try:
            return next(self._inner)
        except StopIteration:
            _finish(self._span, self._tally, self._timed)
            raise
        except Exception:
            _finish(self._span, self._tally, self._timed, status=500)
            raise
        finally:
            set_current(prev)

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close:
            close()
        _finish(self._span, self._tally, self._timed)


class TracedRouter:
    """Router wrapper: extract traceparent, dispatch under a server
    span, finish the span with the response; `tally` counts the
    requests this router's server answered, and `port` is the port its
    first request arrived on."""

    def __init__(self, inner: Router, component: str):
        self.inner = inner
        self.component = component
        self.tally = recorder.RequestTally()
        self.port: int | None = None
        ROUTERS.add(self)

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
                if self.port is None:
                    self.port = conn.getsockname()[1]
            except (OSError, IndexError):
                pass
        timed = (self.component, req.method, req.path) not in UNTIMED
        prev = set_current(span)
        try:
            resp = self.inner.dispatch(req)
        except Exception:
            _finish(span, self.tally, timed, status=500)
            raise
        finally:
            set_current(prev)
        span.status = resp.status
        if resp.stream is not None:
            resp.stream = _SpanStream(resp.stream, span, self.tally, timed)
        else:
            _finish(span, self.tally, timed)
        resp.headers.setdefault("X-Trace-Id", span.trace_id)
        return resp


# every TracedRouter of this process that is still referenced: an
# in-process fleet's servers, told apart by component and port
ROUTERS: "weakref.WeakSet[TracedRouter]" = weakref.WeakSet()


def slow_answers() -> dict[tuple[str, int], list[dict]]:
    """Each server of this process that has answered, by (component,
    port): its slowest timed answers of the telemetry window and those
    no collect has counted yet, slowest first. What holds a server's
    own `p99` in an in-process fleet, where `/debug/slow` is the whole
    process's."""
    out: dict[tuple[str, int], list[dict]] = {}
    for router in list(ROUTERS):
        if router.port is not None:
            out.setdefault((router.component, router.port), []).extend(
                router.tally.slow.entries())
    for answers in out.values():
        answers.sort(key=lambda e: e["duration"], reverse=True)
    return out


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
