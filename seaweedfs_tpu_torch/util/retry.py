"""Unified retry policy, per-peer circuit breaker, and deadline budget.

The port's copy of ``seaweedfs_tpu/util/retry.py``; its ``BREAKERS`` are
the port's own, apart from the reference's.

The reference retries everywhere but each call site hand-rolls it
(weed/operation/upload_content.go retry loop, wdclient re-lookup,
store_replicate fan-out error handling); this module is the single
policy every RPC call site shares:

* ``Policy`` — bounded attempts with exponential backoff and FULL
  jitter (the AWS architecture-blog result: full jitter spreads a
  thundering herd of retriers across the whole backoff window, where
  equal/decorrelated jitter re-synchronizes them).
* retriable classification — transport failures (status 0: refused,
  reset, timeout) and the gateway statuses 502/503/504 retry; 4xx
  NEVER does (the request is wrong, not the path to the peer).
* ``CircuitBreakerRegistry`` — per-peer rolling failure window →
  open → half-open probe, so a dead volume server costs one fast
  refusal instead of a full connect timeout per request.
* deadline budget — a caller's total time budget crosses hops as an
  absolute-epoch ``X-Seaweed-Deadline`` header; every nested request
  clamps its socket timeout to the remaining budget, so retries deep
  in the tree can never outlive the top-level caller.

Leaf module: imports nothing from this package (util/http.py imports
it back).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass

DEADLINE_HEADER = "X-Seaweed-Deadline"

# module-level jitter source for backoff delays; fault determinism
# comes from the fault registry's per-spec seeds, not from here
_rng = random.Random()


@dataclass(frozen=True)
class Policy:
    """One retry policy: attempts, backoff shape, optional total budget.

    ``deadline`` is the WHOLE-call budget in seconds (all attempts and
    backoff sleeps included), folded into the propagated deadline
    header so nested hops inherit it.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: float | None = None
    # ceiling on an honored Retry-After header: a buggy or hostile
    # peer sending "Retry-After: 86400" must not pin the calling
    # thread in sleep when no deadline budget is active
    retry_after_cap: float = 30.0

    def backoff(self, attempt: int) -> float:
        """Delay before attempt ``attempt + 1`` (0-based ``attempt``):
        exponential cap with full jitter."""
        cap = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return _rng.uniform(0.0, cap)


# canned policies for the common call shapes
DEFAULT = Policy()
# control-plane lookups: cheap + idempotent, retry fast
LOOKUP = Policy(max_attempts=3, base_delay=0.05, max_delay=0.5)
# replica fan-out: the caller already holds the local write; one
# quick re-try per peer, then quorum logic decides
REPLICATE = Policy(max_attempts=2, base_delay=0.05, max_delay=0.3)
# data uploads: a re-assign loop sits above this, keep it short
UPLOAD = Policy(max_attempts=3, base_delay=0.05, max_delay=1.0)
# cluster-admin RPCs (maintenance executors, shell verbs): short
# idempotent calls retry like lookups
ADMIN = Policy(max_attempts=3, base_delay=0.05, max_delay=1.0)
# long-running admin mutations (ec generate/copy, compact): ONE
# attempt — the maintenance scheduler's cooldown/requeue is the retry
# layer; blindly replaying a multi-minute copy is worse than failing
ADMIN_LONG = Policy(max_attempts=1)


def retriable(status: int, connection_refused: bool = False) -> bool:
    """Whether a failed request may be retried.

    status 0 is transport-level (refused/reset/timeout) — retriable;
    refused is the SAFEST retry (the peer never saw the request).
    502/503/504 are path/overload statuses the reference retries.
    Anything else — especially every 4xx — is a caller bug or a
    definitive answer and must surface immediately.
    """
    if connection_refused or status == 0:
        return True
    return status in (502, 503, 504)


# -- deadline budget (propagated via X-Seaweed-Deadline) ---------------------


_tls = threading.local()


def deadline() -> float | None:
    """The thread's inherited absolute deadline (epoch seconds), or
    None when no budget is active."""
    return getattr(_tls, "deadline", None)


def set_deadline(abs_ts: float | None) -> float | None:
    """Install an absolute deadline for this thread (the server sets it
    from the inbound header); returns the previous value for restore."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = abs_ts
    return prev


def remaining() -> float | None:
    """Seconds left in the inherited budget (may be <= 0), or None."""
    dl = deadline()
    # the deadline is a wall-clock epoch BY DESIGN: it crosses process
    # boundaries via X-Seaweed-Deadline, so both ends must read the
    # same clock
    return (
        None
        if dl is None
        else dl - time.time()  # weedcheck: ignore[wall-clock-duration]
    )


@contextlib.contextmanager
def deadline_scope(budget_seconds: float):
    """Run a block under a total time budget; nested requests clamp
    their timeouts and propagate the remainder. Never EXTENDS an
    already-tighter inherited deadline."""
    dl = time.time() + budget_seconds
    inherited = deadline()
    prev = set_deadline(dl if inherited is None else min(dl, inherited))
    try:
        yield
    finally:
        set_deadline(prev)


def parse_deadline_header(headers) -> float | None:
    """Extract the absolute deadline from inbound request headers
    (case-insensitive); malformed values are ignored."""
    want = DEADLINE_HEADER.lower()
    for k, v in headers.items():
        if k.lower() == want:
            try:
                return float(v)
            except (TypeError, ValueError):
                return None
    return None


# -- per-peer circuit breaker ------------------------------------------------


class BreakerOpen(Exception):
    """The peer's circuit is open: fail fast instead of dialing."""

    def __init__(self, peer: str, retry_in: float):
        self.peer = peer
        self.retry_in = retry_in
        super().__init__(
            f"circuit open for {peer} (probe in {retry_in:.2f}s)"
        )


class _Breaker:
    """State for one peer; all fields mutated under the registry lock."""

    __slots__ = ("failures", "state", "opened_at", "probe_started")

    def __init__(self):
        self.failures: list[float] = []  # rolling failure timestamps
        self.state = "closed"  # closed | open | half-open
        self.opened_at = 0.0
        self.probe_started = 0.0


class CircuitBreakerRegistry:
    """Per-peer breakers keyed by netloc (host:port).

    closed: failures inside ``window`` accumulate; at ``threshold``
    the breaker opens. open: every check fails fast until ``cooldown``
    elapses, then ONE caller becomes the half-open probe. half-open:
    probe success closes (window cleared); probe failure re-opens.
    Only transport-level failures feed the window — an HTTP status is
    proof the peer is alive.
    """

    def __init__(self, threshold: int = 5, window: float = 5.0,
                 cooldown: float = 0.5, probe_timeout: float = 10.0):
        self.threshold = threshold
        self.window = window
        self.cooldown = cooldown
        self.probe_timeout = probe_timeout
        self._lock = threading.Lock()
        self._peers: dict[str, _Breaker] = {}  # guarded-by: self._lock

    def check(self, peer: str) -> None:
        """Gate one outbound request; raises BreakerOpen to fail fast."""
        # breaker stamps are process-local durations: monotonic clock
        now = time.monotonic()
        with self._lock:
            b = self._peers.get(peer)
            if b is None or b.state == "closed":
                return
            if b.state == "open":
                wait = b.opened_at + self.cooldown - now
                if wait > 0:
                    raise BreakerOpen(peer, wait)
                b.state = "half-open"
                b.probe_started = now
                return  # this caller is the probe
            # half-open: one probe at a time, but a probe that never
            # reported back (caller died) must not wedge the breaker
            if now - b.probe_started > self.probe_timeout:
                b.probe_started = now
                return
            raise BreakerOpen(
                peer, b.probe_started + self.probe_timeout - now
            )

    def record(self, peer: str, ok: bool) -> None:
        """Report one request outcome (transport success/failure)."""
        now = time.monotonic()
        with self._lock:
            b = self._peers.get(peer)
            if ok:
                if b is not None and (b.failures or b.state != "closed"):
                    b.failures.clear()
                    b.state = "closed"
                return
            if b is None:
                b = self._peers.setdefault(peer, _Breaker())
            if b.state == "half-open":
                b.state = "open"  # probe failed: full cooldown again
                b.opened_at = now
                return
            b.failures = [
                t for t in b.failures if now - t < self.window
            ]
            b.failures.append(now)
            if b.state == "closed" and len(b.failures) >= self.threshold:
                b.state = "open"
                b.opened_at = now

    def state(self, peer: str) -> str:
        with self._lock:
            b = self._peers.get(peer)
            return b.state if b is not None else "closed"

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                peer: {
                    "state": b.state,
                    "recent_failures": len(b.failures),
                }
                for peer, b in self._peers.items()
                if b.state != "closed" or b.failures
            }

    def reset(self) -> None:
        with self._lock:
            self._peers = {}


BREAKERS = CircuitBreakerRegistry()
