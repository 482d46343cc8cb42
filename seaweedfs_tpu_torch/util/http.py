"""Minimal threaded HTTP server + client plumbing for the control plane.

The port's copy of ``seaweedfs_tpu/util/http.py``, on the port's own
``fault`` registry and ``tracing.span``. One difference: a server
listens with a backlog of ``socket.SOMAXCONN``, not the standard
library's 5.

The reference runs goroutine-per-request net/http servers
(weed/server/volume_server.go:84-100); the Python equivalent is a
ThreadingHTTPServer with a pattern router. Handlers receive a Request and
return a Response; JSON in/out helpers mirror the reference's writeJson
(weed/server/common.go).

Memory-bounded data plane: handlers get `req.reader` (a BodyReader over
the socket honoring Content-Length or chunked transfer-encoding) so large
uploads never have to materialize (the reference reads request bodies
incrementally, weed/server/filer_server_handlers_write_autochunk.go:232);
`req.body` stays available for small/control requests and drains the
reader lazily on first access. Responses may carry `stream` — an iterator
of byte chunks — which the server writes out incrementally (chunked TE
when `content_length` is unknown), mirroring weed/filer/stream.go.
"""

from __future__ import annotations

import http.client
import io
import itertools
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Iterator

# fault/ and util/retry are leaf modules by design (neither imports
# this module back at import time), as is tracing/span — the tracing
# MIDDLEWARE imports this module, so the tracing package init must
# stay out of this import chain
from .. import fault
from ..tracing import span as trace_span
from . import glog
from . import retry as retry_mod
from .retry import Policy  # re-exported: request(..., retry=Policy(...))


class BodyReader:
    """Bounded file-like reader over a request body.

    Wraps the connection's rfile honoring Content-Length, or decodes
    Transfer-Encoding: chunked (clients streaming an unknown-length
    body). `exhausted` tells the server whether keep-alive framing is
    still intact after the handler ran.
    """

    def __init__(self, rfile, length: int = 0, chunked: bool = False):
        self._rfile = rfile
        self._remaining = length
        self._chunked = chunked
        self._chunk_left = 0  # bytes left in current TE chunk
        self._done = length == 0 and not chunked
        # body ended before the framing said it should (early FIN on a
        # Content-Length body, or EOF before the chunked last-chunk) —
        # lets handlers reject half-received uploads
        self.truncated = False

    @property
    def exhausted(self) -> bool:
        return self._done

    def _read_chunked(self, n: int) -> bytes:
        out = bytearray()
        while n > 0 and not self._done:
            if self._chunk_left == 0:
                if out:
                    # data in hand and the next chunk header isn't
                    # here yet: return instead of blocking — bidi
                    # streams (heartbeat) read incrementally
                    break
                line = self._rfile.readline(256)
                if line and not line.endswith(b"\n"):
                    raise ValueError("chunk size line too long")
                try:
                    self._chunk_left = int(
                        line.strip().split(b";")[0], 16
                    )
                except ValueError:
                    self._done = True
                    self.truncated = True
                    raise ValueError(
                        f"bad chunk size line {line[:32]!r}"
                    ) from None
                if self._chunk_left == 0:  # last-chunk
                    # consume trailer up to the blank line
                    while True:
                        t = self._rfile.readline(1024)
                        if t in (b"\r\n", b"\n", b""):
                            break
                    self._done = True
                    break
            take = min(n, self._chunk_left)
            piece = self._rfile.read(take)
            if not piece:
                self._done = True
                self.truncated = True
                break
            out += piece
            self._chunk_left -= len(piece)
            n -= len(piece)
            if self._chunk_left == 0:
                self._rfile.read(2)  # CRLF after chunk data
        return bytes(out)

    def read(self, n: int = -1) -> bytes:
        if self._done:
            return b""
        if self._chunked:
            if n < 0:
                parts = []
                while not self._done:
                    parts.append(self._read_chunked(1 << 20))
                return b"".join(parts)
            return self._read_chunked(n)
        if n < 0 or n > self._remaining:
            n = self._remaining
        data = self._rfile.read(n) if n else b""
        self._remaining -= len(data)
        if self._remaining == 0:
            self._done = True
        elif n and not data:
            self._done = True
            self.truncated = True
        return data

    def readall(self) -> bytes:
        return self.read(-1)


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
        body: bytes | None = b"",
        match: re.Match | None = None,
        reader: BodyReader | None = None,
    ):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.match = match
        self._body = body if reader is None else None
        if reader is None:
            reader = BodyReader(io.BytesIO(body or b""), len(body or b""))
        self.reader = reader

    @property
    def body(self) -> bytes:
        """Full request body; drains the reader on first access.

        Streaming handlers should use `self.reader` instead and never
        touch `.body` — the two modes are exclusive per request.
        """
        if self._body is None:
            self._body = self.reader.readall()
        return self._body

    def param(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self):
        return json.loads(self.body or b"{}")


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    headers: dict[str, str] = field(default_factory=dict)
    # Streamed response: an iterator of byte chunks written incrementally.
    # When set, `body` is ignored; Content-Length is sent if
    # `content_length` is known, else chunked transfer-encoding is used.
    stream: Iterable[bytes] | None = None
    content_length: int | None = None

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(
            status=status,
            body=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"},
        )

    @classmethod
    def error(cls, msg: str, status: int = 500) -> "Response":
        return cls.json({"error": msg}, status=status)


Handler = Callable[[Request], Response]


class Router:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler,
            prepend: bool = False) -> None:
        """Register a route; `prepend=True` puts it ahead of existing
        routes (dispatch is first-match — debug endpoints must beat
        catch-all data-plane patterns)."""
        route = (method, re.compile(pattern), handler)
        if prepend:
            self._routes.insert(0, route)
        else:
            self._routes.append(route)

    def dispatch(self, req: Request) -> Response:
        for method, pattern, handler in self._routes:
            if method != "*" and req.method != method:
                continue
            m = pattern.fullmatch(req.path)
            if m:
                req.match = m
                return handler(req)
        return Response.error(f"no route for {req.method} {req.path}", 404)


# Cluster transport security (weed/security/tls.go model): when a
# client SSL context is configured, scheme-less URLs dial https and
# present the client certificate — one switch turns the whole
# control+data plane into mTLS.
_client_tls = {"context": None, "scheme": "http"}


def configure_client_tls(context) -> None:
    """Install the cluster client TLS context (None reverts to http)."""
    _client_tls["context"] = context
    _client_tls["scheme"] = "https" if context is not None else "http"


def _absolutize(url: str) -> str:
    if not url.startswith("http"):
        return f"{_client_tls['scheme']}://{url}"
    return url


class HttpServer:
    """Threaded HTTP server wrapping a Router; start()/stop()
    lifecycle. `ssl_context` (security/tls.py server_context) turns
    the listener into HTTPS/mTLS."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None):
        self.router = router
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Nagle + delayed-ACK stalls small keep-alive responses
            # (headers and body go out as separate tiny writes) by
            # tens of ms; the reference's Go net/http sets NODELAY on
            # every accepted connection, so match it
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet
                pass

            def _serve(self):
                parsed = urllib.parse.urlsplit(self.path)
                te = (self.headers.get("Transfer-Encoding") or "").lower()
                chunked = "chunked" in te
                length = int(self.headers.get("Content-Length") or 0)
                reader = BodyReader(self.rfile, length, chunked)
                req = Request(
                    method=self.command,
                    path=parsed.path,
                    query=urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True
                    ),
                    headers={k: v for k, v in self.headers.items()},
                    reader=reader,
                )
                # long-lived stream handlers (heartbeat bidi) need the
                # raw connection to arm read deadlines
                req.connection = self.connection
                # the caller's deadline budget crosses the hop as a
                # header; install it thread-locally so every nested
                # outbound request this handler makes clamps to it
                # (util/retry.py) — cleared in the finally below even
                # for keep-alive threads serving many requests
                prev_dl = retry_mod.set_deadline(
                    retry_mod.parse_deadline_header(req.headers)
                )
                try:
                    resp = outer.router.dispatch(req)
                except Exception as e:  # handler crash → 500
                    resp = Response.error(f"{type(e).__name__}: {e}", 500)
                first: bytes | None = None
                try:
                    if resp.stream is not None:
                        # prime the producer so an error raised before
                        # the first byte still yields a clean 500 (not
                        # a 200 with a truncated body)
                        resp.stream = iter(resp.stream)
                        try:
                            first = next(resp.stream, b"")
                        except Exception as e:
                            resp = Response.error(
                                f"{type(e).__name__}: {e}", 500
                            )
                    try:
                        self.send_response(resp.status)
                        for k, v in resp.headers.items():
                            self.send_header(k, v)
                        if resp.stream is not None:
                            self._write_stream(resp, first)
                        else:
                            self.send_header(
                                "Content-Length", str(len(resp.body))
                            )
                            self.end_headers()
                            if self.command != "HEAD":
                                self.wfile.write(resp.body)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                finally:
                    retry_mod.set_deadline(prev_dl)
                if not reader.exhausted:
                    # handler didn't consume the body; close instead of
                    # draining an arbitrarily large upload
                    self.close_connection = True

            def _write_stream(
                self, resp: Response, first: bytes | None
            ) -> None:
                use_chunked = resp.content_length is None
                if use_chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                else:
                    self.send_header(
                        "Content-Length", str(resp.content_length)
                    )
                self.end_headers()
                if self.command == "HEAD":
                    return
                try:
                    for piece in itertools.chain(
                        [first or b""], resp.stream
                    ):
                        if not piece:
                            continue
                        if use_chunked:
                            self.wfile.write(
                                f"{len(piece):x}\r\n".encode()
                                + piece + b"\r\n"
                            )
                        else:
                            self.wfile.write(piece)
                    if use_chunked:
                        self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                except Exception:
                    # producer failed mid-stream: headers are already
                    # out, so the only honest signal is a truncated
                    # connection (chunked: missing last-chunk)
                    self.close_connection = True
                finally:
                    close = getattr(resp.stream, "close", None)
                    if close:
                        close()

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _serve

        class _Server(ThreadingHTTPServer):
            # the listen backlog: the standard library's 5 overflows
            # when the accepting thread is held off (a busy process,
            # many servers in one interpreter), and the kernel drops
            # each SYN past it, so the client waits 1, 3, 7, 15 s on
            # its retransmits; Go's net/http listens with somaxconn
            request_queue_size = socket.SOMAXCONN

            def handle_error(self, request, client_address):
                # keep-alive connections severed mid-read (client
                # process exit, test teardown) are routine, not errors
                import sys as _sys

                # sys.exception() is 3.12+; exc_info works everywhere
                exc = _sys.exc_info()[1]
                if isinstance(
                    exc,
                    (ConnectionResetError, BrokenPipeError,
                     ConnectionAbortedError, TimeoutError),
                ):
                    return
                super().handle_error(request, client_address)

        self._httpd = _Server((host, port), _Handler)
        self._httpd.daemon_threads = True
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True
            )
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# -- client helpers ----------------------------------------------------------


class HttpError(Exception):
    def __init__(
        self, status: int, body: bytes,
        connection_refused: bool = False,
        retry_after: float | None = None,
    ):
        self.status = status
        self.body = body
        # True only when the TCP connection could not be ESTABLISHED:
        # the peer definitely never received the request, so a retry
        # elsewhere cannot duplicate work. Timeouts/resets/5xx leave
        # the request's fate UNKNOWN and must not set this.
        self.connection_refused = connection_refused
        # server-requested retry delay (Retry-After on a 503), honored
        # by the retry loop as a backoff floor
        self.retry_after = retry_after
        # the request never left this process: the peer's circuit is
        # open / the caller's deadline budget was already spent
        self.circuit_open = False
        self.deadline_exceeded = False
        super().__init__(f"http {status}: {body[:200]!r}")


def _parse_retry_after(headers) -> float | None:
    if headers is None:
        return None
    v = headers.get("Retry-After")
    if not v:
        return None
    try:
        return max(0.0, float(v))
    except ValueError:
        return None  # HTTP-date form: not worth honoring here


def list_filer_dir(
    filer_url: str, dir_path: str, page: int = 1000,
    retry: "Policy | None" = None,
) -> list[dict]:
    """All entries of a filer directory, following lastFileName
    pagination — callers must never trust a single truncated page
    (shared by the broker segment scan and admin tooling)."""
    entries: list[dict] = []
    last = ""
    while True:
        out = get_json(
            f"{filer_url}{dir_path.rstrip('/')}/"
            f"?limit={page}&lastFileName={urllib.parse.quote(last)}",
            retry=retry,
        )
        batch = out.get("Entries") or []
        if not batch:
            break
        entries.extend(batch)
        last = batch[-1]["FullPath"].rsplit("/", 1)[-1]
        if len(batch) < page and not out.get(
            "ShouldDisplayLoadMore"
        ):
            break
    return entries


# A connect that has not completed in this many seconds is abandoned and
# tried again on a new socket (a new source port) while the caller's
# timeout lasts. In chip_smoke.py's phase-18 fill on an H100 host, about
# one loopback connect to the filer in several thousand got no answer at
# all (no established socket, no server span) until the client's 30 s
# ran out. Safe to repeat: a connect that never completed sent nothing.
CONNECT_TRY_SECONDS = 5.0
_create_connection = socket.create_connection


def _connect(address, timeout=socket._GLOBAL_DEFAULT_TIMEOUT,
             source_address=None):
    """``socket.create_connection`` whose connect tries last at most
    ``CONNECT_TRY_SECONDS`` each, within ``timeout`` in all; the socket
    it returns has ``timeout`` for what follows."""
    if not isinstance(timeout, (int, float)) or \
            timeout <= CONNECT_TRY_SECONDS:
        return _create_connection(address, timeout, source_address)
    end = time.monotonic() + timeout
    while True:
        left = end - time.monotonic()
        try:
            sock = _create_connection(
                address, min(CONNECT_TRY_SECONDS, left), source_address
            )
        except TimeoutError:
            if end - time.monotonic() <= 0.05:
                raise
            glog.warningf(
                "connect to %s:%s: no answer in %.1f s, a new socket",
                address[0], address[1], min(CONNECT_TRY_SECONDS, left),
            )
            continue
        sock.settimeout(timeout)
        return sock


class _HTTPConnection(http.client.HTTPConnection):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._create_connection = _connect


class _HTTPSConnection(http.client.HTTPSConnection):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._create_connection = _connect


class _HTTPHandler(urllib.request.HTTPHandler):
    def http_open(self, req):
        return self.do_open(_HTTPConnection, req)


class _HTTPSHandler(urllib.request.HTTPSHandler):
    def https_open(self, req):
        return self.do_open(_HTTPSConnection, req, context=self._context)


_openers: dict[int, tuple] = {}  # id(tls context) -> (context, opener)


def _opener(ctx) -> urllib.request.OpenerDirector:
    """urllib's opener with the connect above, one a TLS context."""
    hit = _openers.get(id(ctx))
    if hit is None or hit[0] is not ctx:
        opener = urllib.request.build_opener(
            _HTTPHandler, _HTTPSHandler(context=ctx)
        )
        hit = _openers[id(ctx)] = (ctx, opener)
    return hit[1]


def _is_conn_refused(e: Exception) -> bool:
    if isinstance(e, ConnectionRefusedError):
        return True
    reason = getattr(e, "reason", None)
    return isinstance(reason, ConnectionRefusedError)


def _gate_send(method: str, url: str, deadline: float | None,
               timeout: float) -> tuple[str, float]:
    """Shared pre-send gate for request/request_stream: circuit
    breaker, deadline budget, and the http.client.send fault point.
    Returns (netloc, clamped timeout); raises HttpError to fail fast
    WITHOUT dialing."""
    netloc = urllib.parse.urlsplit(url).netloc
    try:
        retry_mod.BREAKERS.check(netloc)
    except retry_mod.BreakerOpen as e:
        err = HttpError(0, str(e).encode())
        err.circuit_open = True
        raise err from None
    if deadline is not None:
        # X-Seaweed-Deadline is a cross-process wall-clock epoch: both
        # hops must read the same clock, so time.time() is correct here
        left = deadline - time.time()  # weedcheck: ignore[wall-clock-duration]
        if left <= 0:
            err = HttpError(0, b"deadline exceeded")
            err.deadline_exceeded = True
            raise err
        timeout = min(timeout, left)
    try:
        fault.point("http.client.send", url=url, method=method)
    except fault.FaultInjected as f:
        if f.kind == "error":
            raise HttpError(
                f.status, str(f).encode()
            ) from None
        # conn_drop / partition: transport-level — feeds the breaker
        # exactly like a real dead peer; partition is refused
        # semantics (the peer never saw the request)
        retry_mod.BREAKERS.record(netloc, ok=False)
        raise HttpError(
            0, str(f).encode(),
            connection_refused=f.kind == "partition",
        ) from None
    return netloc, timeout


def _effective_deadline(retry: "Policy | None") -> float | None:
    """Absolute deadline for one call: the tighter of the inherited
    (header-propagated) budget and the policy's own."""
    dl = retry_mod.deadline()
    if retry is not None and retry.deadline is not None:
        own = time.time() + retry.deadline
        dl = own if dl is None else min(dl, own)
    return dl


def _send_once(
    method: str,
    url: str,
    body: bytes | None,
    headers: dict | None,
    timeout: float,
    tls: str,
    deadline: float | None,
) -> bytes:
    netloc, timeout = _gate_send(method, url, deadline, timeout)
    # propagate the active trace context on every hop (tracing/span.py);
    # copy so the caller's dict is never mutated
    headers = trace_span.inject(dict(headers or {}))
    if deadline is not None:
        headers.setdefault(retry_mod.DEADLINE_HEADER, f"{deadline:.6f}")
    req = urllib.request.Request(
        url, data=body, method=method, headers=headers
    )
    ctx = _client_tls["context"] if tls == "cluster" else None
    try:
        with _opener(ctx).open(req, timeout=timeout) as resp:
            data = resp.read()
    except urllib.error.HTTPError as e:
        # an HTTP status is PROOF the peer is alive: transport ok
        retry_mod.BREAKERS.record(netloc, ok=True)
        raise HttpError(
            e.code, e.read(),
            retry_after=_parse_retry_after(e.headers),
        ) from None
    except (urllib.error.URLError, socket.timeout, ConnectionError) as e:
        retry_mod.BREAKERS.record(netloc, ok=False)
        raise HttpError(
            0, str(e).encode(),
            connection_refused=_is_conn_refused(e),
        ) from None
    retry_mod.BREAKERS.record(netloc, ok=True)
    return data


def request(
    method: str,
    url: str,
    body: bytes | Iterable[bytes] | None = None,
    headers: dict | None = None,
    timeout: float = 30.0,
    tls: str = "cluster",
    retry: "Policy | None" = None,
) -> bytes:
    """One-shot request returning the full response body.

    `body` may be bytes, or an iterator/file-like of byte chunks — the
    latter is sent with chunked transfer-encoding so the client never
    materializes a large upload (weed/operation/upload_content.go streams
    from an io.Reader the same way).

    `tls="cluster"` (default) presents the cluster mTLS context for
    https; `tls="public"` uses system trust — external endpoints (e.g.
    a real cloud S3 tier) must not be verified against the cluster CA.

    `retry` opts into the unified retry policy (util/retry.py):
    exponential backoff with full jitter across transport failures and
    502/503/504 (Retry-After honored as a floor, clamped to the
    policy's retry_after_cap; 4xx NEVER retried),
    bounded by the policy's and the inherited deadline budget. Every
    request — retried or not — passes the per-peer circuit breaker and
    propagates the deadline header.
    """
    url = _absolutize(url)
    if body is not None and not isinstance(body, (bytes, bytearray)):
        # a streamed body can only be consumed once: no retry loop
        with request_stream(
            method, url, body, headers, timeout, tls=tls
        ) as r:
            return r.read()
    deadline = _effective_deadline(retry)
    attempts = retry.max_attempts if retry is not None else 1
    for attempt in range(attempts):
        try:
            return _send_once(
                method, url, body, headers, timeout, tls, deadline
            )
        except HttpError as e:
            if (
                retry is None
                or attempt + 1 >= attempts
                or e.deadline_exceeded
                or not retry_mod.retriable(
                    e.status, e.connection_refused
                )
            ):
                raise
            delay = retry.backoff(attempt)
            if e.retry_after is not None:
                # honored as a backoff floor, but clamped: the sleep
                # is server-chosen input (see Policy.retry_after_cap)
                delay = max(
                    delay, min(e.retry_after, retry.retry_after_cap)
                )
            if (
                deadline is not None
                and time.time() + delay >= deadline
            ):
                raise  # the budget can't fund another attempt
            time.sleep(delay)
    raise AssertionError("unreachable")  # loop always returns/raises


class StreamResponse:
    """Incremental-read response handle from `request_stream`."""

    def __init__(self, resp, conn=None):
        self._resp = resp
        self._conn = conn
        self.status = resp.status
        self.headers = dict(resp.headers.items())

    def read(self, n: int = -1) -> bytes:
        return self._resp.read() if n < 0 else self._resp.read(n)

    def iter(self, piece_size: int = 1 << 20) -> Iterator[bytes]:
        while True:
            piece = self.read(piece_size)
            if not piece:
                return
            yield piece

    def close(self) -> None:
        try:
            self._resp.close()
        finally:
            if self._conn is not None:
                self._conn.close()

    def __enter__(self) -> "StreamResponse":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def request_stream(
    method: str,
    url: str,
    body: bytes | Iterable[bytes] | None = None,
    headers: dict | None = None,
    timeout: float = 30.0,
    tls: str = "cluster",
) -> StreamResponse:
    """Request whose response is read incrementally (weed/filer/stream.go
    consumer side). Raises HttpError for >=400 statuses (body drained).
    Passes the breaker/deadline/fault gate but never retries — a
    streamed exchange cannot be replayed."""
    url = _absolutize(url)
    deadline = retry_mod.deadline()
    netloc, timeout = _gate_send(method, url, deadline, timeout)
    headers = trace_span.inject(dict(headers or {}))
    if deadline is not None:
        headers.setdefault(retry_mod.DEADLINE_HEADER, f"{deadline:.6f}")
    parts = urllib.parse.urlsplit(url)
    if parts.scheme == "https":
        conn = http.client.HTTPSConnection(
            parts.netloc, timeout=timeout,
            context=(
                _client_tls["context"] if tls == "cluster" else None
            ),
        )
    else:
        conn = http.client.HTTPConnection(
            parts.netloc, timeout=timeout
        )
    conn._create_connection = _connect
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    kwargs = {}
    if body is not None and not isinstance(body, (bytes, bytearray)):
        if hasattr(body, "read"):
            reader = body
            body = iter(lambda: reader.read(1 << 20), b"")
        kwargs["encode_chunked"] = True
    try:
        conn.request(
            method, target, body=body, headers=headers or {}, **kwargs
        )
        resp = conn.getresponse()
    except (socket.timeout, ConnectionError, http.client.HTTPException) as e:
        conn.close()
        retry_mod.BREAKERS.record(netloc, ok=False)
        raise HttpError(
            0, str(e).encode(),
            connection_refused=_is_conn_refused(e),
        ) from None
    retry_mod.BREAKERS.record(netloc, ok=True)
    if resp.status >= 400:
        data = resp.read()
        retry_after = _parse_retry_after(resp.headers)
        conn.close()
        raise HttpError(resp.status, data, retry_after=retry_after)
    return StreamResponse(resp, conn)


def get_json(url: str, timeout: float = 30.0,
             retry: "Policy | None" = None):
    return json.loads(
        request("GET", url, timeout=timeout, retry=retry) or b"{}"
    )


def post_json(url: str, obj=None, timeout: float = 30.0,
              retry: "Policy | None" = None):
    body = json.dumps(obj or {}).encode()
    out = request(
        "POST", url, body,
        {"Content-Type": "application/json"}, timeout, retry=retry,
    )
    return json.loads(out or b"{}")


# -- multipart/form-data (upload parsing) ------------------------------------


@dataclass
class MultipartPart:
    """One part of a multipart/form-data body."""

    name: str
    filename: str | None
    mime: str
    data: bytes
    headers: dict[str, str]


def parse_multipart(body: bytes, content_type: str) -> list[MultipartPart]:
    """Minimal multipart/form-data parser for upload bodies.

    Behavioral model: weed/storage/needle/needle_parse_upload.go
    parseMultipart — the volume server accepts `curl -F file=@x` style
    POSTs and stores only the file part's bytes, taking name/mime from
    the part headers.
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError(f"no multipart boundary in {content_type!r}")
    # RFC 2046: delimiters are line-anchored (CRLF--boundary), so a
    # binary payload containing "--boundary" mid-line is not split.
    # Normalize the leading delimiter (body starts with --boundary).
    delim = b"\r\n--" + m.group(1).encode()
    first = b"--" + m.group(1).encode()
    if body.startswith(first):
        body = b"\r\n" + body
    parts: list[MultipartPart] = []
    for seg in body.split(delim)[1:]:
        if seg.startswith(b"--"):
            break  # closing delimiter
        seg = seg.removeprefix(b"\r\n")
        head, sep, data = seg.partition(b"\r\n\r\n")
        if not sep:
            continue
        # (the part-terminating CRLF is part of the line-anchored
        # delimiter, so `data` is already exact)
        headers: dict[str, str] = {}
        for line in head.split(b"\r\n"):
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().decode().lower()] = v.strip().decode()
        cd = headers.get("content-disposition", "")
        nm = re.search(r'name="([^"]*)"', cd)
        fn = re.search(r'filename="([^"]*)"', cd)
        parts.append(
            MultipartPart(
                name=nm.group(1) if nm else "",
                filename=fn.group(1) if fn else None,
                mime=headers.get("content-type", ""),
                data=data,
                headers=headers,
            )
        )
    return parts
