"""Raft-lite consensus for the master control plane.

Behavioral model: weed/server/raft_server.go:21-55 (chrislusf/raft with a
max-volume-id state machine) + weed/topology/cluster_commands.go
(`MaxVolumeIdCommand`). The reference replicates exactly one kind of
fact — monotonic allocation counters — so this implementation specializes
raft to that shape: the "log" is a single versioned state record
``{max_volume_id, seq_ceiling}``. Because both counters are monotone and
every new entry supersedes the last, last-entry-only replication carries
the same information as a full raft log, and the standard raft safety
rules apply unchanged:

* **Terms + voting**: one vote per term, majority elects; a vote is only
  granted to a candidate whose (state term, state version) is at least as
  up-to-date as the voter's — the raft election restriction, which
  guarantees a new leader has every committed state.
* **Commit rule**: the leader only treats a state version as committed
  (and only refreshes its lease) when a majority acks a version stamped
  with its *current* term — on election the new leader re-stamps and
  re-replicates its state (raft's no-op entry) before serving.
* **Leader lease**: ``is_leader()`` requires a majority ack newer than
  ``lease_s`` ago (measured from the send start). ``lease_s`` is shorter
  than the minimum election timeout, so by the time a partitioned
  ex-leader could be superseded its lease has already expired and it
  stops serving assigns. Even under clock skew, uniqueness of volume ids
  and file keys never rests on the lease alone: both are handed out only
  below ceilings that were majority-committed, and a minority-partitioned
  leader cannot extend a ceiling.

Transport is JSON-over-HTTP like the rest of the control plane
(`/raft/vote`, `/raft/append` routed by the master). A ``blocked`` set
drops traffic to/from given peers in both directions — the partition
seam the failover tests use.

The port's copy of ``seaweedfs_tpu/server/raft.py``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from .. import fault
from ..util import glog, http


class NoQuorumError(Exception):
    """A proposal could not reach a majority — the caller must fail the
    client request rather than hand out an uncommitted id."""


class RaftLite:
    def __init__(
        self,
        self_url: str,
        peers: list[str],
        pulse_seconds: float = 0.5,
        send=None,
        state_dir: str | None = None,
    ):
        self.url = self_url
        self.cluster = sorted(set(list(peers) + [self_url]))
        self.majority = len(self.cluster) // 2 + 1
        self.pulse = pulse_seconds
        # lease < min election timeout: a superseded leader's lease runs
        # out before any peer could have been elected in a newer term.
        self.lease_s = 3.0 * pulse_seconds
        self._timeout_range = (5.0 * pulse_seconds, 10.0 * pulse_seconds)

        self.term = 0
        self.voted_for: str | None = None
        self.role = "follower"
        self.leader_url: str | None = None

        # Versioned replicated state (the 1-entry "log"). ``state`` is
        # the latest stored record — like a raft log tail it may be
        # UNCOMMITTED and can be superseded after a leader change.
        # Consumers that hand out ids (sequencer, vid commit) must read
        # ``committed_state`` only: it advances exactly when a version is
        # majority-acked in the leader's current term.
        self.state: dict[str, int] = {"max_volume_id": 0, "seq_ceiling": 0}
        self.committed_state: dict[str, int] = dict(self.state)
        self.version = 0
        self.vterm = 0  # term in which this version was created
        self.committed_version = 0

        self._lease_until = 0.0
        # monotonic stamp of the last election THIS node won; the
        # master uses its age as the "fleet still re-homing" window
        # for assign warm-up semantics (0.0 = never won one here)
        self.leader_since = 0.0
        self._election_deadline = self._next_deadline()
        self.blocked: set[str] = set()  # partition seam (tests)
        self._send = send or self._http_send
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=max(4, len(peers) * 2))
        self._running = False
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        # Durable (term, voted_for, versioned state): raft's safety
        # argument REQUIRES these survive a restart — a node that votes,
        # crashes, and forgets could vote twice in one term and elect
        # two leaders (the reference persists via chrislusf/raft's log,
        # raft_server.go:21-53). Counters additionally re-seed the
        # sequencer ceilings after a full-cluster restart.
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self._state_path = os.path.join(
                state_dir, "raft_state.json"
            )
        else:
            self._state_path = None
        self._load_durable()

    # -- durable state ---------------------------------------------------

    def _load_durable(self) -> None:
        if not self._state_path or not os.path.exists(self._state_path):
            return
        try:
            with open(self._state_path) as f:
                d = json.load(f)
            # parse into locals first: a half-bad file must not leave
            # the node with half-assigned raft metadata
            term = int(d.get("term", 0))
            voted_for = d.get("voted_for")
            state = dict(d.get("state") or self.state)
            version = int(d.get("version", 0))
            vterm = int(d.get("vterm", 0))
        except (OSError, ValueError, TypeError) as e:
            glog.errorf(
                "raft state %s unreadable (%s); starting fresh",
                self._state_path, e,
            )
            return
        self.term = term
        self.voted_for = voted_for
        self.state = state
        self.version = version
        self.vterm = vterm
        # committed state re-proves itself via the next leader's no-op
        # commit; restart conservatively treats the stored tail as
        # uncommitted (a real raft reloads commitIndex the same way)
        self.committed_state = dict(self.state)
        self.committed_version = 0

    def _persist(self) -> bool:  # weedcheck: holds[self._lock]
        """Write-then-rename under the lock; called on every term /
        vote / state change (the fsync'd raft metadata write). Skips
        the fsync when nothing changed — steady-state heartbeats hit
        the >=-equal adoption path several times a second. Returns
        False when durability could not be achieved."""
        if not self._state_path:
            return True
        record = (
            self.term, self.voted_for, dict(self.state),
            self.version, self.vterm,
        )
        if record == getattr(self, "_persisted", None):
            return True
        tmp = self._state_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "term": self.term,
                        "voted_for": self.voted_for,
                        "state": self.state,
                        "version": self.version,
                        "vterm": self.vterm,
                    },
                    f,
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._state_path)
            self._persisted = record
            return True
        except OSError as e:
            # losing durability silently would defeat the double-vote
            # protection this file exists for — shout about it
            glog.errorf(
                "raft state persist to %s FAILED (%s): votes/terms "
                "will not survive a restart",
                self._state_path, e,
            )
            return False

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if len(self.cluster) == 1:
            with self._lock:
                self.role = "leader"
                self.leader_url = self.url
        self._running = True
        self._ticker.start()

    def stop(self) -> None:
        self._running = False
        self._pool.shutdown(wait=False)

    # -- public queries --------------------------------------------------

    def is_leader(self) -> bool:
        with self._lock:
            if len(self.cluster) == 1:
                return True
            return (
                self.role == "leader"
                and time.monotonic() < self._lease_until
            )

    def leader(self) -> str | None:
        with self._lock:
            if self.role == "leader" and (
                len(self.cluster) == 1
                or time.monotonic() < self._lease_until
            ):
                return self.url
            return self.leader_url

    # -- proposals -------------------------------------------------------

    def propose(self, **updates: int) -> dict[str, int]:
        """Apply monotonic counter updates and replicate to a majority.

        Returns the COMMITTED state. Raises NoQuorumError if this node is
        not the leader or cannot reach a majority; in that case the new
        values are stored (like an uncommitted raft log entry) but
        ``committed_state`` is untouched, so no caller can ever serve an
        id from a value that a post-failover leader might not have.
        """
        with self._lock:
            if self.role != "leader":
                raise NoQuorumError(f"not leader (role={self.role})")
            for key, value in updates.items():
                if value < self.state.get(key, 0):
                    raise ValueError(
                        f"{key} must be monotonic: {value} < "
                        f"{self.state.get(key)}"
                    )
                self.state[key] = value
            self.version += 1
            self.vterm = self.term
            self._persist()
            want = self.version
        if not self._replicate(want):
            raise NoQuorumError(
                f"no majority ack for version {want} (term {self.term})"
            )
        with self._lock:
            return dict(self.committed_state)

    # -- replication -----------------------------------------------------

    def _replicate(self, want_version: int) -> bool:
        """Push state to peers concurrently; True when a majority (incl.
        self) stores ``want_version`` stamped with our current term."""
        with self._lock:
            if self.role != "leader":
                return False
            term = self.term
            shipped = dict(self.state)
            payload = {
                "term": term,
                "leader": self.url,
                "version": self.version,
                "vterm": self.vterm,
                "state": shipped,
                "committed_version": self.committed_version,
                "committed_state": dict(self.committed_state),
            }
        sent_version = payload["version"]  # >= want_version
        t_start = time.monotonic()
        acks = 1  # self
        for resp in self._rpc_fanout("/raft/append", payload):
            if resp is None:
                continue
            if resp.get("term", 0) > term:
                self._observe_term(resp["term"])
                return False
            if resp.get("ok") and resp.get("version", 0) >= sent_version:
                acks += 1
        if acks >= self.majority or len(self.cluster) == 1:
            with self._lock:
                if self.role == "leader" and self.term == term:
                    if sent_version > self.committed_version:
                        self.committed_version = sent_version
                        self.committed_state = shipped
                    self._lease_until = t_start + self.lease_s
                    return sent_version >= want_version
        return False

    # -- RPC handlers (wired into the master's router) -------------------

    def handle_append(self, msg: dict) -> dict:
        sender = msg.get("leader", "")
        if sender in self.blocked:
            raise http.HttpError(503, b"partitioned (test seam)")
        with self._lock:
            if msg["term"] < self.term:
                return {"ok": False, "term": self.term}
            if msg["term"] > self.term:
                self.term = msg["term"]
                self.voted_for = None
                self._persist()
            self.role = "follower"
            self.leader_url = sender
            self._election_deadline = self._next_deadline()
            if (msg["vterm"], msg["version"]) >= (self.vterm, self.version):
                self.state = dict(msg["state"])
                self.version = msg["version"]
                self.vterm = msg["vterm"]
                self._persist()
                committed = min(msg["committed_version"], self.version)
                if committed > self.committed_version:
                    # Only advance committed_version together with the
                    # state it refers to, keeping the invariant
                    # "committed_state corresponds to committed_version"
                    # true on followers too (not just leaders).
                    if committed == self.version:
                        self.committed_version = committed
                        self.committed_state = dict(msg["state"])
                    elif "committed_state" in msg:
                        self.committed_version = committed
                        self.committed_state = dict(
                            msg["committed_state"]
                        )
            return {"ok": True, "term": self.term, "version": self.version}

    def handle_vote(self, msg: dict) -> dict:
        sender = msg.get("candidate", "")
        if sender in self.blocked:
            raise http.HttpError(503, b"partitioned (test seam)")
        with self._lock:
            if msg["term"] < self.term:
                return {"granted": False, "term": self.term}
            if msg["term"] > self.term:
                self.term = msg["term"]
                self.voted_for = None
                self._persist()
                if self.role == "leader":
                    self.role = "follower"
            up_to_date = (msg["vterm"], msg["version"]) >= (
                self.vterm,
                self.version,
            )
            if self.voted_for in (None, sender) and up_to_date:
                prev = self.voted_for
                self.voted_for = sender
                if not self._persist():
                    # an unpersisted vote could be re-granted to a
                    # different candidate after a crash: refuse
                    self.voted_for = prev
                    return {"granted": False, "term": self.term}
                self._election_deadline = self._next_deadline()
                return {"granted": True, "term": self.term}
            return {"granted": False, "term": self.term}

    # -- internals -------------------------------------------------------

    def _tick_loop(self) -> None:
        while self._running:
            time.sleep(self.pulse / 2)
            try:
                with self._lock:
                    role = self.role
                    deadline = self._election_deadline
                if role == "leader":
                    if len(self.cluster) > 1:
                        with self._lock:
                            want = self.version
                        self._replicate(want)
                elif time.monotonic() > deadline:
                    self._campaign()
            except Exception as e:
                # A persistent fault here (e.g. a serialization bug in
                # _replicate) would otherwise silently stall elections
                # and heartbeats (weed/raft logs these via glog too).
                glog.V(1).infof(
                    "raft tick error on %s: %s: %s",
                    self.url, type(e).__name__, e,
                )

    def _campaign(self) -> None:
        with self._lock:
            self.term += 1
            term = self.term
            self.role = "candidate"
            self.voted_for = self.url
            self._persist()  # term + self-vote must survive a crash
            # a candidate knows no leader: the previous leader's
            # heartbeats stopped (or never reached us) — keeping the
            # old URL would let a partitioned follower forever claim a
            # leader it can't reach
            self.leader_url = None
            self._election_deadline = self._next_deadline()
            payload = {
                "term": term,
                "candidate": self.url,
                "version": self.version,
                "vterm": self.vterm,
            }
        votes = 1
        for resp in self._rpc_fanout("/raft/vote", payload):
            if resp is None:
                continue
            if resp.get("term", 0) > term:
                self._observe_term(resp["term"])
                return
            if resp.get("granted"):
                votes += 1
        if votes < self.majority:
            return
        with self._lock:
            if self.term != term or self.role != "candidate":
                return
            self.role = "leader"
            self.leader_url = self.url
            self.leader_since = time.monotonic()
            self._lease_until = 0.0  # no authority until first quorum ack
            # raft's no-op entry: re-stamp the state in the new term so
            # the commit rule can apply to it
            self.version += 1
            self.vterm = term
            self._persist()
            want = self.version
        self._replicate(want)

    def _observe_term(self, term: int) -> None:
        with self._lock:
            if term > self.term:
                self.term = term
                self.role = "follower"
                self.voted_for = None
                self._persist()
                self._election_deadline = self._next_deadline()

    def _next_deadline(self) -> float:
        return time.monotonic() + random.uniform(*self._timeout_range)

    def _rpc_fanout(self, path: str, payload: dict) -> list[dict | None]:
        """Send to every peer CONCURRENTLY with one shared deadline — a
        black-holed peer must not stretch the round past the lease (one
        slow peer serialized would eat the whole lease margin)."""
        futures = []
        for peer in self.cluster:
            if peer == self.url or peer in self.blocked:
                continue
            try:
                futures.append(
                    self._pool.submit(self._send, peer, path, payload)
                )
            except RuntimeError:  # pool shut down
                return []
        deadline = time.monotonic() + max(0.5, 2 * self.pulse)
        out: list[dict | None] = []
        for fut in futures:
            try:
                out.append(
                    fut.result(
                        timeout=max(0.0, deadline - time.monotonic())
                    )
                )
            except Exception:
                out.append(None)
        return out

    def _http_send(self, peer: str, path: str, payload: dict) -> dict:
        # injected faults (error/latency/partition toward a peer
        # substring) propagate into _rpc_fanout's except → None, i.e.
        # exactly the shape of a dead peer — no special-casing needed
        fault.point("raft.msg.send", peer=peer, path=path)
        return http.post_json(
            f"{peer}{path}", payload, timeout=max(0.5, 2 * self.pulse)
        )


class RaftSequencer:
    """File-key sequencer whose ceiling is raft-committed.

    The leader leases blocks of keys by committing ``seq_ceiling`` through
    the raft state machine; keys are only handed out below the committed
    ceiling, so two partitioned masters can never produce the same key: a
    new leader starts above the last committed ceiling, and the old
    leader's remaining lease block is disjoint by construction.
    (Reference analog: weed/sequence/memory_sequencer.go, made safe the
    way the etcd sequencer is — block leases — weed/sequence/.)
    """

    def __init__(self, raft: RaftLite, block: int = 4096):
        self.raft = raft
        self.block = block
        self._counter = 1
        self._epoch = -1  # raft term the counter was aligned to
        self._lock = threading.Lock()

    def _align(self) -> None:  # weedcheck: holds[self._lock]
        """On first use in a new term, skip past the committed ceiling —
        ids below it may have been served by a previous leader."""
        if self._epoch != self.raft.term:
            self._counter = self.raft.committed_state["seq_ceiling"] + 1
            self._epoch = self.raft.term

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            self._align()
            end = self._counter + count - 1
            # Keys are only ever handed out below the COMMITTED ceiling —
            # a value that failed quorum lives in raft.state but must
            # never back an id (a post-failover leader may not have it).
            if end > self.raft.committed_state["seq_ceiling"]:
                committed = self.raft.propose(seq_ceiling=end + self.block)
                if end > committed["seq_ceiling"]:
                    raise NoQuorumError(
                        "ceiling commit did not cover the request"
                    )
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            self._align()
            if seen >= self._counter:
                self._counter = seen + 1
                if self._counter > self.raft.committed_state["seq_ceiling"]:
                    try:
                        self.raft.propose(
                            seq_ceiling=self._counter + self.block
                        )
                    except NoQuorumError:
                        pass  # next assign will surface the failure
