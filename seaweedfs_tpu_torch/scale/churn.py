"""Seeded churn: kill/revive servers at tunable rates under load.

Every action (what, which servers, when) comes off one
`random.Random(seed)` stream and is appended to an action log with
monotonic time offsets, so a failing scale round is replayable from
its seed alone — the log is evidence, the seed is the reproduction.

The port's copy of ``seaweedfs_tpu/scale/churn.py``.
"""

from __future__ import annotations

import random
import threading
import time

from .harness import ScaleHarness

# churn profiles (the `kind` field):
#   flat    — kill one random live server per tick, never revive
#   burst   — kill one whole random rack per tick ("lose a rack")
#   rolling — restart one random server per tick (rolling restart:
#             every kill is followed by an immediate revive)
#   warm    — flat-style kills while the maintenance plane EC-encodes
#             seeded warm-tier volumes (the kill schedule is flat's;
#             the warm semantics — small volume limit, seeded full
#             volumes, ec_encode task type — live in scale/round.py)
#   leader  — kill the current raft LEADER mid-ingest (first tick,
#             once), then flat-style volume kills; requires a
#             multi-master harness so the survivors can elect
KINDS = ("flat", "burst", "rolling", "warm", "leader")


class ChurnProfile:
    """How to churn: `kind`, tick `interval` seconds, and `max_kills`
    (total servers the engine may leave dead; rolling ignores it —
    restarts don't reduce the fleet)."""

    def __init__(self, kind: str = "flat", interval: float = 1.0,
                 max_kills: int = 0):
        if kind not in KINDS:
            raise ValueError(f"unknown churn kind {kind!r}")
        self.kind = kind
        self.interval = interval
        self.max_kills = max_kills

    def __repr__(self) -> str:
        return (
            f"ChurnProfile({self.kind}, interval={self.interval}, "
            f"max_kills={self.max_kills})"
        )


class ChurnEngine:
    """Background churn driver over a ScaleHarness.

    `start()` spawns the loop; `stop()` sets the Event and joins.
    `min_live` floors the fleet — the engine never kills below it, so
    a long round can't churn the cluster into an unwritable stump."""

    def __init__(
        self,
        harness: ScaleHarness,
        profile: ChurnProfile,
        seed: int = 0,
        min_live: int | None = None,
    ):
        self.harness = harness
        self.profile = profile
        self.seed = seed
        self.rnd = random.Random(seed)
        self.min_live = (
            min_live
            if min_live is not None
            else max(3, harness.spec.total_servers // 2)
        )
        self.actions: list[dict] = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = time.monotonic()
        self.kills = 0
        # leader-kill bookkeeping (scale/round.py turns these into the
        # failover_converge_s / election-window metrics)
        self.leader_kills = 0
        self.leader_kill_mono: float | None = None  # guarded-by: self._lock
        self.leader_elected_mono: float | None = None  # guarded-by: self._lock
        self.new_leader_idx: int | None = None  # guarded-by: self._lock

    # -- action primitives (each one logged + tagged) --------------------

    def _log(self, action: str, targets: list[int]) -> None:
        entry = {
            "t": round(time.monotonic() - self._t0, 3),
            "action": action,
            "servers": targets,
            "seed": self.seed,
        }
        with self._lock:
            self.actions.append(entry)

    def kill_random(self, n: int = 1) -> list[int]:
        """Kill up to `n` random live servers (respecting min_live)."""
        killed: list[int] = []
        for _ in range(n):
            live = self.harness.live_indices()
            if len(live) <= self.min_live:
                break
            i = self.rnd.choice(live)
            self.harness.kill_volume_server(i)
            killed.append(i)
        if killed:
            self.kills += len(killed)
            self._log("kill", killed)
        return killed

    def kill_rack_random(self) -> list[int]:
        live = self.harness.live_indices()
        spr = self.harness.spec.servers_per_rack
        if len(live) - spr < self.min_live:
            return []
        rack = self.rnd.randrange(self.harness.spec.total_racks)
        killed = self.harness.kill_rack(rack)
        if killed:
            self.kills += len(killed)
            self._log("kill-rack", killed)
        return killed

    def restart_random(self) -> list[int]:
        live = self.harness.live_indices()
        if len(live) <= self.min_live:
            return []
        i = self.rnd.choice(live)
        self.harness.kill_volume_server(i)
        self.harness.restart_volume_server(i)
        self._log("restart", [i])
        return [i]

    def kill_leader(self) -> int | None:
        """Kill the current raft leader; returns its master index, or
        None when the harness is single-master / mid-election / would
        lose quorum. Deterministic — no RNG draw, so the volume-kill
        schedule after it replays bit-for-bit from the seed."""
        h = self.harness
        if getattr(h, "n_masters", 1) < 2:
            return None
        majority = h.n_masters // 2 + 1
        if h.n_masters - len(h.masters_down) - 1 < majority:
            # killing the leader now would drop below quorum and no
            # successor could ever commit; revive the oldest downed
            # master first so the fleet keeps an electable majority
            j = min(h.masters_down, default=None)
            if j is None:
                return None
            h.restart_master(j)
            self._log("restart_master", [j])
        idx = h.current_leader_index()
        if idx is None:
            return None
        with self._lock:
            self.leader_kill_mono = time.monotonic()
            self.leader_elected_mono = None
            self.new_leader_idx = None
        h.kill_master(idx)
        self.leader_kills += 1
        self._log("kill_leader", [idx])
        threading.Thread(
            target=self._watch_election,
            args=(idx,),
            name="churn-election-watch",
            daemon=True,
        ).start()
        return idx

    def _watch_election(self, old_idx: int) -> None:
        """Stamp the moment a DIFFERENT live master takes the lease.
        Observation only — it never appends to the action log (its
        timing is the cluster's, not the seed's, and a timing-driven
        entry would break replay determinism)."""
        h = self.harness
        deadline = time.monotonic() + max(30.0, 60 * h.pulse)
        while time.monotonic() < deadline and not self._stop.is_set():
            for i, m in enumerate(h.masters):
                if (
                    i != old_idx
                    and i not in h.masters_down
                    and m.is_leader
                ):
                    with self._lock:
                        self.leader_elected_mono = time.monotonic()
                        self.new_leader_idx = i
                    return
            time.sleep(0.05)

    def revive_all(self) -> list[int]:
        revived = sorted(self.harness.down)
        for i in revived:
            self.harness.restart_volume_server(i)
        if revived:
            self._log("revive", revived)
        return revived

    # -- the driver loop -------------------------------------------------

    def _tick(self) -> None:
        p = self.profile
        if p.kind == "rolling":
            self.restart_random()
            return
        if p.kind == "leader" and self.leader_kills == 0:
            # the one leader kill lands on the FIRST tick — mid-ingest
            # by construction (the load phase started before the
            # engine) and early enough that the round's convergence
            # window contains the whole election
            if self.kill_leader() is not None:
                return
        if p.max_kills and self.kills >= p.max_kills:
            return
        if p.kind == "burst":
            self.kill_rack_random()
        else:
            self.kill_random(1)

    def _loop(self) -> None:
        while not self._stop.wait(self.profile.interval):
            self._tick()

    def start(self) -> None:
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="churn", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self) -> "ChurnEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
