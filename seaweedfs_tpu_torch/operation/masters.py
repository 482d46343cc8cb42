"""Leader-aware master ring: the client-side re-find-leader rotation.

Behavioral model: weed/wdclient/masterclient.go:57-120 — every client
that talks to the master tier keeps the full candidate list and, when
its current target stops being the leader, re-finds one by (a)
following the ``leader`` hint a not-leader error body carries, (b)
asking each candidate ``/cluster/status`` for the leader, or (c)
blindly rotating to the next candidate when a peer is plain dead.
`operation/watch.py` grew this logic first for the location
push-stream; this module is the shared form the benchmark's fid
assigns, `maintenance/ops.py` RPCs, and the scale convergence poller
thread through, layered OVER `util/retry.Policy` (each attempt against
one master still rides the caller's retry policy + circuit breaker;
the ring only decides WHICH master the next attempt targets).

The ring lock guards only the cached leader pointer — it is never held
across an HTTP call, so a stalled master can't serialize every client
behind one resolve.

The port's copy of ``seaweedfs_tpu/operation/masters.py``.
"""

from __future__ import annotations

import json
import threading
import time

from ..stats.metrics import (
    MASTER_LEADER_RESOLVES,
    MASTER_RING_ROTATIONS,
)
from ..util import glog, http


def leader_hint(err: Exception) -> str | None:
    """The ``leader`` field of a not-leader error body, if any (the
    shape `_not_leader_response` / the 503 watch redirect emit)."""
    try:
        body = getattr(err, "body", b"") or b"{}"
        hint = json.loads(body).get("leader")
        return hint or None
    except (ValueError, AttributeError):
        return None


class MasterRing:
    """A fixed candidate set of master URLs with a cached leader."""

    def __init__(self, urls, status_timeout: float = 5.0,
                 election_patience_s: float = 15.0):
        if isinstance(urls, str):
            urls = [urls]
        urls = [u.rstrip("/") for u in urls if u]
        if not urls:
            raise ValueError("empty master ring")
        # stable de-dup: the first url is the caller's preferred home
        self._urls: list[str] = list(dict.fromkeys(urls))
        self.status_timeout = status_timeout
        # how long call() rides out a leaderless cluster before giving
        # up: must outlast a worst-case election (randomized timeout up
        # to 10 pulses, plus the vote round) or mid-failover callers
        # see errors instead of a latency spike
        self.election_patience_s = election_patience_s
        self._lock = threading.Lock()
        self._leader = self._urls[0]  # guarded-by: self._lock

    def __len__(self) -> int:
        return len(self._urls)

    @property
    def urls(self) -> list[str]:
        return list(self._urls)

    def leader(self) -> str:
        """Current best-guess leader (never blocks, may be stale)."""
        with self._lock:
            return self._leader

    def _slot(self, url: str) -> str:
        # bounded metric label: ring index, or the one "external"
        # bucket for a hint outside the configured candidate set
        try:
            return str(self._urls.index(url))
        except ValueError:
            return "external"

    def note_leader(self, url: str, reason: str = "hint") -> str:
        url = (url or "").rstrip("/")
        if not url:
            return self.leader()
        with self._lock:
            changed = url != self._leader
            self._leader = url
        if changed:
            MASTER_RING_ROTATIONS.inc(self._slot(url), reason)
            glog.V(2).infof(
                "master ring: leader -> %s (%s)", url, reason
            )
        return url

    def rotate(self, failed: str) -> str:
        """Advance past a dead candidate (conn-refused, breaker open)
        — the blind arm of masterclient.go's rotation."""
        try:
            i = self._urls.index((failed or "").rstrip("/"))
        except ValueError:
            i = -1
        return self.note_leader(
            self._urls[(i + 1) % len(self._urls)], "rotate"
        )

    def resolve(self) -> str | None:
        """Sweep ``/cluster/status`` over the candidates for a node
        that claims leadership ITSELF; returns (and caches) it, or
        None mid-election. Dead candidates are skipped, the cached
        leader is asked first (one round-trip in steady state). A
        follower's ``Leader`` field is deliberately ignored: it is
        hearsay that keeps pointing at the DEAD master until the
        follower's own election timer fires, and trusting it mid
        failover sends every retry straight back to the corpse."""
        cur = self.leader()
        candidates = [cur] + [u for u in self._urls if u != cur]
        for url in candidates:
            try:
                st = http.get_json(
                    f"{url}/cluster/status",
                    timeout=self.status_timeout,
                )
            except (http.HttpError, OSError):
                continue
            if st.get("IsLeader"):
                MASTER_LEADER_RESOLVES.inc("found")
                return self.note_leader(url, "status")
        MASTER_LEADER_RESOLVES.inc("no_leader")
        return None

    def call(self, fn, attempts: int | None = None):
        """Run ``fn(leader_url)`` with leader re-resolution around it:
        follow ``leader`` hints in error bodies, re-resolve through
        ``/cluster/status`` (falling back to blind rotation) on
        transport failures and retriable statuses, and surface the
        last error once the budget is spent. Non-retriable HTTP errors
        (a real 4xx) raise immediately — those are the caller's bug,
        not an election.

        When resolve() finds NO self-claimed leader the cluster is
        mid-election. Those waits draw on a TIME budget
        (``election_patience_s``, escalating sleeps capped at 0.5s)
        rather than the attempt budget: an election's length is set by
        the randomized timeout, not by how many times the client asks,
        so a fixed attempt count would give up exactly when patience
        is the whole point — the failover users never see costs them a
        latency spike, not an error. When a leader IS resolvable the
        failure is the data plane's, attempts burn normally, and
        retries stay immediate."""
        if attempts is None:
            attempts = 3 * len(self._urls) + 2
        last: Exception | None = None
        url = self.leader()
        deadline = time.monotonic() + self.election_patience_s
        i = 0
        waits = 0
        while i < max(1, attempts):
            try:
                return fn(url)
            except http.HttpError as e:
                last = e
                hint = leader_hint(e)
                if hint and hint.rstrip("/") != url:
                    url = self.note_leader(hint, "hint")
                    i += 1
                    continue
                # status 0 covers conn-refused, open breakers, and
                # injected partitions; 5xx covers mid-election "no
                # leader" refusals from followers
                if e.status not in (0, 502, 503, 504):
                    raise
            except OSError as e:
                last = e
            resolved = self.resolve()
            if resolved is not None:
                url = resolved
                i += 1
                continue
            # no leader anywhere: an election is running — wait out a
            # slice of it on the time budget, then re-ask from the
            # blind-rotation candidate
            url = self.rotate(url)
            if time.monotonic() < deadline:
                waits += 1
                time.sleep(min(0.1 * waits, 0.5))
                continue
            i += 1
        raise last  # type: ignore[misc]  # loop ran >= 1 attempt

    # convenience wrappers for the common JSON RPC shapes

    def get_json(self, path: str, **kw):
        return self.call(lambda u: http.get_json(f"{u}{path}", **kw))

    def post_json(self, path: str, payload, **kw):
        return self.call(
            lambda u: http.post_json(f"{u}{path}", payload, **kw)
        )


def ring_of(master) -> MasterRing:
    """Coerce a master url | url list | MasterRing into a ring."""
    if isinstance(master, MasterRing):
        return master
    return MasterRing(master)
