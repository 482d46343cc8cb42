"""MaintenancePlane: the master-leader-resident detect→schedule loop.

Owns the policy, the detector round thread (leader-only, paused by a
held shell cluster lock), the scheduler + workers, and the cluster
admin-lock sharing that keeps autonomous tasks and manual `weed shell`
operations strictly serialized: while any task runs the plane holds
the admin lock (refcounted, so concurrent workers share one hold), and
while a shell holds it the whole plane stands down.

The detector loop is the package's own lifecycle discipline: it blocks
on a `threading.Event` stop flag (`Event.wait(interval)`), never a
bare `time.sleep` — the pattern the `loop-without-stop` weedcheck rule
enforces for every new background loop (ROADMAP).

The port's copy of ``seaweedfs_tpu/maintenance/plane.py``.
"""

from __future__ import annotations

import itertools
import threading
import time

from ..util import glog
from . import scheduler as sched_mod
from .detector import Detector
from .policy import MaintenancePolicy
from .tasks import VACUUM

LOCK_CLIENT = "maintenance-plane"


class MaintenancePlane:
    def __init__(self, master, policy: MaintenancePolicy | None = None):
        self.master = master
        self.policy = policy or MaintenancePolicy.from_env()
        self.detector = Detector(master)
        self.scheduler = sched_mod.MaintenanceScheduler(self)
        self.paused = False
        self.rounds = 0
        self.last_round = 0.0
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._lock_depth = 0  # guarded-by: self._lock
        self._batch_seq = itertools.count(1)
        self.started = False

    # -- lifecycle -------------------------------------------------------

    @property
    def active(self) -> bool:
        return self.started and self.policy.enabled

    def start(self) -> None:
        if self.started or not self.policy.enabled:
            return
        self.started = True
        self.scheduler.start()
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="maint-detector"
        )
        self._loop_thread.start()
        glog.infof(
            "maintenance plane started: interval=%.1fs types=%s",
            self.policy.interval, ",".join(self.policy.task_types),
        )

    def ensure_workers(self) -> None:
        """Spin up the executor pool for operator-forced runs on a
        plane that never auto-started (policy disabled). The detector
        loop stays off — only the explicit round runs."""
        if not self.started:
            self.started = True
            self.scheduler.start()

    def stop(self) -> None:
        self._stop.set()
        self.scheduler.stop()

    def _loop(self) -> None:
        # stop-flag wait IS the interval sleep: shutdown never blocks
        # on a sleeping detector
        while not self._stop.wait(self.policy.interval):
            if self.gate_reason() is not None:
                continue
            try:
                self.run_round()
            except Exception as e:
                glog.warningf("maintenance: detector round failed: %s", e)

    # -- gating ----------------------------------------------------------

    def gate_reason(self) -> str | None:
        """Why the plane must not dispatch right now (None = clear):
        paused by an operator, not the leader, or a `weed shell`
        holding the cluster admin lock."""
        if self.paused:
            return "paused"
        if not self.master.is_leader:
            return "not leader"
        holder = self.shell_lock_holder()
        if holder is not None:
            return f"shell lock held by {holder}"
        return None

    def shell_lock_holder(self) -> str | None:
        """The foreign admin-lock holder, if any (fresh within the
        master's lease window)."""
        m = self.master
        with m._lock:
            holder = m._admin_lock_holder
            if (
                holder
                and holder != LOCK_CLIENT
                and time.monotonic() - m._admin_lock_ts < 60
            ):
                return holder
        return None

    def acquire_cluster_lock(self) -> bool:
        """Share the cluster admin lock for one task run (refcounted —
        concurrent workers extend the same hold). False when a shell
        holds it."""
        m = self.master
        with self._lock:
            with m._lock:
                holder = m._admin_lock_holder
                now = time.monotonic()
                if (
                    holder
                    and holder != LOCK_CLIENT
                    and now - m._admin_lock_ts < 60
                ):
                    return False
                m._admin_lock_holder = LOCK_CLIENT
                m._admin_lock_ts = now
            self._lock_depth += 1
            return True

    def release_cluster_lock(self) -> None:
        m = self.master
        with self._lock:
            if self._lock_depth > 0:
                self._lock_depth -= 1
            if self._lock_depth == 0:
                with m._lock:
                    if m._admin_lock_holder == LOCK_CLIENT:
                        m._admin_lock_holder = None

    # -- rounds ----------------------------------------------------------

    def run_round(
        self,
        types: tuple[str, ...] | None = None,
        garbage_threshold: float | None = None,
        batch: str = "",
    ) -> list:
        """One detect→submit round; returns the accepted tasks."""
        candidates = self.detector.detect(
            self.policy, types=types,
            garbage_threshold=garbage_threshold,
        )
        accepted = self.scheduler.submit(candidates, batch=batch)
        # the detector loop and operator-forced rounds (POST
        # /cluster/maintenance run) land on different threads: the
        # round counters update under the plane lock
        with self._lock:
            self.rounds += 1
            self.last_round = time.time()
        sched_mod.MAINT_LAST_ROUND.set(self.last_round)
        return accepted

    def enqueue_vacuum_batch(
        self, garbage_threshold: float, bytes_per_second: int
    ) -> tuple[str, list]:
        """The async /vol/vacuum intake: detect vacuum candidates at
        the request's threshold, stamp them with a batch id, enqueue.
        Progress is visible in `maintenance.status` and
        GET /cluster/maintenance?batch=<id>."""
        batch = f"vacuum-{next(self._batch_seq)}"
        candidates = self.detector.vacuum_candidates(garbage_threshold)
        for cand in candidates:
            cand["detail"]["garbage_threshold"] = garbage_threshold
            cand["detail"]["bytes_per_second"] = bytes_per_second
        accepted = self.scheduler.submit(candidates, batch=batch)
        self.scheduler.wake()
        return batch, accepted

    # -- control / views -------------------------------------------------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False
        self.scheduler.wake()

    def update_policy(self, updates: dict) -> MaintenancePolicy:
        self.policy = self.policy.merge(updates)
        return self.policy

    def telemetry(self) -> dict:
        """The compact maintenance section of the master's telemetry
        snapshot: queue depth, per-outcome counters, cadence, and the
        backlog-age signal `cluster.health` flags."""
        queued, running, _ = self.scheduler.queue_view()
        counters = self.scheduler.counters()
        return {
            "enabled": self.policy.enabled,
            "paused": self.paused,
            "queued": len(queued),
            "running": len(running),
            "completed": counters.get("completed", 0),
            "failed": counters.get("failed", 0),
            "skipped": counters.get("skipped", 0),
            "interval": self.policy.interval,
            "last_round": self.last_round,
            "rounds": self.rounds,
            "backlog_seconds": round(
                self.scheduler.backlog_seconds(), 3
            ),
        }

    def view(self, batch: str | None = None) -> dict:
        queued, running, history = self.scheduler.queue_view()
        if batch:
            queued = [t for t in queued if t["batch"] == batch]
            running = [t for t in running if t["batch"] == batch]
            history = [t for t in history if t["batch"] == batch]
        return {
            "enabled": self.policy.enabled,
            "active": self.active,
            "paused": self.paused,
            "gate": self.gate_reason(),
            "policy": self.policy.to_dict(),
            "rounds": self.rounds,
            "last_round": self.last_round,
            "backlog_seconds": round(
                self.scheduler.backlog_seconds(), 3
            ),
            "counters": self.scheduler.counters(),
            "queued": queued,
            "running": running,
            "history": history[-50:],
        }
