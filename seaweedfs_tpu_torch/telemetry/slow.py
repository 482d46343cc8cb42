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

The port's copy of ``seaweedfs_tpu/telemetry/slow.py``.
"""

from __future__ import annotations

import heapq
import threading

_CAPACITY = 64


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


# process-wide ledger, shared by every in-proc server (the same scoping
# as the span recorder ring — one per real deployment process)
LEDGER = SlowLedger()
