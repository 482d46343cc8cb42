"""Push-based volume-location streaming (KeepConnected analog).

Behavioral model: weed/server/master_grpc_server.go:173-228 — the master
pushes `VolumeLocation` deltas (new/deleted vids per server URL, plus
node-down events) to every connected subscriber the moment a heartbeat
or unregister changes the topology, so clients never serve stale
locations until a failed request forces a poll.

Transport here is an ndjson HTTP stream (one JSON event per line, blank
lines as keepalives) served through the streaming response layer —
the HTTP analog of the reference's server-side gRPC stream.

The port's copy of ``seaweedfs_tpu/server/location_watch.py``.
"""

from __future__ import annotations

import collections
import threading
import uuid


class LocationBroadcaster:
    """Bounded, self-compacting replayable event log + wakeup for
    connected watchers.

    `epoch` identifies THIS broadcaster instance: sequence numbers are
    per-process, so a watcher that reconnects across a master failover
    presents a stale epoch and must be reset (otherwise its old seq
    silently filters out every event from the new leader's fresh log).

    Compaction: a `full` or `down` event for a URL supersedes every
    earlier event for that URL — a watcher that receives the later
    event ends in the same state whether or not it saw the older ones.
    Publishing one drops the superseded history, so 100 servers
    reconnecting after a churn burst replay O(live servers + recent
    deltas), not the whole capacity window. Sequence gaps left by
    compaction are therefore SAFE to skip; only capacity eviction
    (the deque dropping an event nothing superseded) forces a resync.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._events: collections.deque = collections.deque()
        self.seq = 0
        self.epoch = uuid.uuid4().hex[:12]
        # highest seq dropped for CAPACITY (not compaction): watchers
        # at or past it may skip gaps; watchers behind it must resync
        self._evicted_seq = 0
        self.compacted = 0  # superseded events dropped (observability)
        self._cond = threading.Condition()

    def publish(self, event: dict) -> int:
        """Append one location event; wakes all waiting streams."""
        with self._cond:
            self.seq += 1
            url = event.get("url")
            if url and event.get("type") in ("full", "down"):
                kept = collections.deque(
                    (s, e)
                    for s, e in self._events
                    if e.get("url") != url
                )
                self.compacted += len(self._events) - len(kept)
                self._events = kept
            while len(self._events) >= self.capacity:
                old_seq, _ = self._events.popleft()
                self._evicted_seq = max(self._evicted_seq, old_seq)
            self._events.append((self.seq, event))
            self._cond.notify_all()
            return self.seq

    def since(self, seq: int) -> tuple[list[tuple[int, dict]], bool]:
        """Events after `seq`; second value False when the watcher is
        behind a capacity eviction (it may have missed an event nothing
        superseded, so it must full-resync). Gaps from compaction are
        replayed over silently — the surviving events carry the same
        end state."""
        with self._cond:
            if seq > 0 and seq < self._evicted_seq:
                return [], False
            return [(s, e) for s, e in self._events if s > seq], True

    def wait(self, seq: int, timeout: float) -> None:
        with self._cond:
            if any(s > seq for s, _ in self._events):
                return
            self._cond.wait(timeout)

    def size(self) -> int:
        """Current replay-log length (a flight-recorder probe: growth
        here means watchers are falling behind compaction)."""
        with self._cond:
            return len(self._events)


def heartbeat_delta(hb, dn, full: bool) -> dict | None:
    """Build the VolumeLocation event for one processed heartbeat
    (master_grpc_server.go:20-170 builds the same message from the
    heartbeat's full/delta volume + EC lists)."""
    if full:
        return {
            "type": "full",
            "url": dn.url,
            "public_url": dn.public_url,
            "vids": sorted({v.id for v in hb.volumes}),
            "ec_vids": sorted({m.id for m in hb.ec_shards}),
        }
    new_vids = sorted({v.id for v in hb.new_volumes})
    deleted_vids = sorted({v.id for v in hb.deleted_volumes})
    new_ec = sorted({m.id for m in hb.new_ec_shards})
    deleted_ec = sorted({m.id for m in hb.deleted_ec_shards})
    if not (new_vids or deleted_vids or new_ec or deleted_ec):
        return None
    return {
        "type": "delta",
        "url": dn.url,
        "public_url": dn.public_url,
        "new_vids": new_vids,
        "deleted_vids": deleted_vids,
        "new_ec_vids": new_ec,
        "deleted_ec_vids": deleted_ec,
    }


def node_down_event(dn) -> dict:
    """Unregister broadcast (master_grpc_server.go:22-50 DeletedVids on
    a broken heartbeat stream)."""
    return {"type": "down", "url": dn.url}
