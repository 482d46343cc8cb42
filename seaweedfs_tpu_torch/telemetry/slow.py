"""Slow-request ledger: a bounded record of the N slowest requests.

`p99 is burning` is an aggregate; the operator's next question is
"WHICH request". Every server keeps the process's N slowest finished
request spans (op, duration, status, peer, trace id, fault tags) in a
min-heap keyed by duration — O(log N) per offer, bounded memory, no
sampling daemon — fed by the tracing middleware and served at
`/debug/slow`. `weed shell trace.slow` merges the ledgers so the jump
from a burning SLO to the exact `trace.dump -traceId ...` is two
commands.

Leaf module (stdlib only): imported by the tracing middleware, which
sits under every server's router.

The port's copy of ``seaweedfs_tpu/telemetry/slow.py``. Two
differences: an entry carries its span's ``hops`` (a filer write's
upload tries, ``server/filer.py``; a volume allocation's parts,
``server/volume.py``), ``grow``, ``keys_s`` and ``proxy`` (an assign's
wait for the master's grow and the grow's allocations, its sequencer
seconds, a follower's forward to the leader; ``server/master.py``)
where the span has them; and ``WindowSlow`` keeps one
server's slowest timed answers of its telemetry window, so an
in-process fleet can name what each marked server's ``p99`` holds.
"""

from __future__ import annotations

import heapq
import threading
import time

_CAPACITY = 64
# span attributes an entry carries where the span has them
_CARRIED = ("hops", "grow", "keys_s", "proxy")


class SlowLedger:
    """Keeps the `capacity` slowest entries ever offered."""

    def __init__(self, capacity: int = _CAPACITY,
                 floor_seconds: float = 0.0):
        self.capacity = capacity
        # entries faster than this never enter (0 = keep everything
        # until the ledger is full, then only new maxima displace)
        self.floor_seconds = floor_seconds
        self._lock = threading.Lock()
        # min-heap of (duration, seq, entry): the fastest of the slow
        # is the root, displaced first  # guarded-by: self._lock
        self._heap: list[tuple[float, int, dict]] = []
        self._seq = 0  # guarded-by: self._lock

    def offer(self, entry: dict) -> bool:
        """Consider one finished request; True if it entered the ledger."""
        duration = float(entry.get("duration", 0.0))
        if duration < self.floor_seconds:
            return False
        with self._lock:
            self._seq += 1
            item = (duration, self._seq, entry)
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, item)
                return True
            if duration > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)
                return True
            return False

    def offer_span(self, span) -> bool:
        """Build a ledger entry from a finished tracing Span: the
        middleware's feed point. Fault tags injected during the request
        (fault/__init__.py tags the active span) ride along, so a
        chaos-injected stall is visibly chaos in the ledger."""
        attrs = getattr(span, "attrs", {}) or {}
        entry = {
            "component": span.component,
            "op": span.op,
            "duration": span.duration,
            "status": span.status,
            "start": span.start,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "peer": attrs.get("peer", ""),
            "faults": {
                k: v for k, v in attrs.items() if k.startswith("fault.")
            },
        }
        for key in _CARRIED:
            if key in attrs:
                entry[key] = attrs[key]
        return self.offer(entry)

    def entries(self, limit: int = 0) -> list[dict]:
        """Snapshot, slowest first; `limit` trims the tail."""
        with self._lock:
            items = sorted(self._heap, reverse=True)
        out = [entry for (_d, _s, entry) in items]
        if limit > 0:
            out = out[:limit]
        return out

    def clear(self) -> None:
        with self._lock:
            self._heap = []


class WindowSlow:
    """One server's slowest timed answers of its telemetry window: at
    most ``capacity`` entries, the fastest displaced first. An answer
    enters the window at the collect that counts it (``stamp``, called
    by the server's ``TelemetryCollector`` with the collect's monotonic
    time), as the snapshot's latency buckets do, and leaves it
    ``window_seconds`` later; until that collect it is pending, and
    shown."""

    def __init__(self, capacity: int = 16, window_seconds: float = 30.0):
        self.capacity = capacity
        self.window_seconds = window_seconds
        self._lock = threading.Lock()
        # [collect time or None, duration, entry]  # guarded-by: self._lock
        self._items: list[list] = []

    def _kept(self, now: float) -> list[list]:  # weedcheck: holds[self._lock]
        horizon = now - self.window_seconds
        return [it for it in self._items
                if it[0] is None or it[0] >= horizon]

    def offer_span(self, span) -> None:
        attrs = getattr(span, "attrs", {}) or {}
        entry = {"op": span.op, "duration": span.duration,
                 "status": span.status, "trace_id": span.trace_id}
        for key in _CARRIED:
            if key in attrs:
                entry[key] = attrs[key]
        with self._lock:
            items = self._kept(time.monotonic())
            items.append([None, float(span.duration), entry])
            if len(items) > self.capacity:
                items.remove(min(items, key=lambda it: it[1]))
            self._items = items

    def stamp(self, now: float) -> None:
        """A collect at monotonic ``now`` counted the pending answers."""
        with self._lock:
            for it in self._items:
                if it[0] is None:
                    it[0] = now
            self._items = self._kept(now)

    def entries(self, limit: int = 0,
                now: float | None = None) -> list[dict]:
        """The window's answers and the pending ones, slowest first;
        `limit` trims."""
        with self._lock:
            items = self._kept(time.monotonic() if now is None else now)
        out = [e for _t, _d, e in sorted(
            items, key=lambda it: it[1], reverse=True)]
        return out[:limit] if limit > 0 else out


# process-wide ledger, shared by every in-proc server (the same scoping
# as the span recorder ring — one per real deployment process)
LEDGER = SlowLedger()
