"""Scheduler: priority queue + caps + cooldowns → executor workers.

The `weed worker` task plane analog, folded into the master process:
tasks the detector (or the async /vol/vacuum batch intake) submits are
deduped against the live set, held back by per-(type, volume)
cooldowns, and dispatched to a small worker pool under per-node and
per-task-type concurrency caps. Every run:

* is gated on the cluster admin lock (a held `weed shell` lock pauses
  dispatch entirely; each task additionally shares the lock while it
  runs so a shell can never lock mid-task),
* consults the telemetry plane first and SKIPS (with a cooldown) when
  a target node's snapshot is stale or its circuit breaker is open —
  maintenance must never pile work onto a struggling node,
* passes the ``maintenance.task.run`` fault point (chaos suite hook),
* runs as a ``maintenance.<type>`` trace span feeding /debug/traces,
* lands in ``seaweedfs_maintenance_*`` metrics and a bounded history
  ring served by ``GET /cluster/maintenance``.

The port's copy of ``seaweedfs_tpu/maintenance/scheduler.py``.
"""

from __future__ import annotations

import threading
import time
import urllib.parse
from collections import deque

from .. import fault, tracing
from ..stats.metrics import REGISTRY
from ..util import glog
from ..util import retry as retry_mod
from . import ops
from . import tasks as T

MAINT_TASKS = REGISTRY.counter(
    "seaweedfs_maintenance_tasks_total",
    "Counter of maintenance tasks by type and outcome.",
    ("type", "outcome"),
)
MAINT_TASK_SECONDS = REGISTRY.histogram(
    "seaweedfs_maintenance_task_seconds",
    "Bucketed histogram of maintenance task run time.",
    ("type",),
)
MAINT_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_maintenance_queue_depth",
    "Maintenance tasks currently queued or running.",
    ("state",),
)
MAINT_LAST_ROUND = REGISTRY.gauge(
    "seaweedfs_maintenance_last_round_timestamp_seconds",
    "Epoch seconds of the last completed detector round.",
)


def _netloc(url: str) -> str:
    if "//" not in url:
        return url
    return urllib.parse.urlsplit(url).netloc


class MaintenanceScheduler:
    def __init__(self, plane):
        self._plane = plane
        # Condition doubles as the state lock: queue/running/history
        # mutate under it, workers wait on it for new work
        self._lock = threading.Condition()
        self._queue: list[T.MaintenanceTask] = []  # guarded-by: self._lock
        self._running: dict[int, T.MaintenanceTask] = {}  # guarded-by: self._lock
        self._history: deque = deque(  # guarded-by: self._lock
            maxlen=plane.policy.history_size
        )
        # (type, vid) -> terminal-outcome epoch  # guarded-by: self._lock
        self._cooldowns: dict[tuple[str, int], float] = {}
        self._counters: dict[str, int] = {  # guarded-by: self._lock
            T.COMPLETED: 0, T.FAILED: 0, T.SKIPPED: 0,
        }
        self._stop = threading.Event()
        self._workers: list[threading.Thread] = []
        self._executors = {
            T.VACUUM: self._exec_vacuum,
            T.EC_ENCODE: self._exec_ec_encode,
            T.EC_REBUILD: self._exec_ec_rebuild,
            T.FIX_REPLICATION: self._exec_fix_replication,
            T.BALANCE: self._exec_balance,
        }

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        for i in range(max(1, self._plane.policy.workers)):
            th = threading.Thread(
                target=self._worker, daemon=True,
                name=f"maint-worker-{i}",
            )
            th.start()
            self._workers.append(th)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._lock.notify_all()

    # -- intake ----------------------------------------------------------

    def submit(
        self, candidates: list[dict], batch: str = ""
    ) -> list[T.MaintenanceTask]:
        """Enqueue candidates that survive dedupe (one live task per
        (type, volume)) and the post-run cooldown; returns the
        accepted tasks."""
        now = time.time()
        cooldown = self._plane.policy.cooldown_seconds
        accepted: list[T.MaintenanceTask] = []
        with self._lock:
            live = {t.key() for t in self._queue}
            live |= {t.key() for t in self._running.values()}
            for cand in candidates:
                task = T.MaintenanceTask(batch=batch, **cand)
                if task.type not in self._executors:
                    continue
                key = task.key()
                if key in live:
                    continue
                # an encode spreads its shards one node group at a time,
                # so the master's map shows the volume short of shards
                # until the encode ends: that is no loss to rebuild
                if (task.type == T.EC_REBUILD
                        and (T.EC_ENCODE, task.volume_id) in live):
                    continue
                # cooldown stamps are task.finished wall epochs — the
                # same values /cluster/maintenance displays — so the
                # compare stays on the wall clock with them
                if now - self._cooldowns.get(key, 0.0) < cooldown:  # weedcheck: ignore[wall-clock-duration]
                    continue
                live.add(key)
                self._queue.append(task)
                accepted.append(task)
            if accepted:
                self._refresh_depth_locked()
                self._lock.notify_all()
        for task in accepted:
            glog.infof(
                "maintenance: queued %s volume=%d (%s)",
                task.type, task.volume_id, task.reason,
            )
        return accepted

    # -- dispatch --------------------------------------------------------

    def _refresh_depth_locked(self) -> None:  # weedcheck: holds[self._lock]
        MAINT_QUEUE_DEPTH.set(float(len(self._queue)), "queued")
        MAINT_QUEUE_DEPTH.set(float(len(self._running)), "running")

    def _pick_locked(self) -> T.MaintenanceTask | None:  # weedcheck: holds[self._lock]
        """Highest-priority dispatchable task, or None. Caps: at most
        per_type_concurrency running tasks per type, and at most
        per_node_concurrency running tasks touching any given node."""
        policy = self._plane.policy
        by_type: dict[str, int] = {}
        busy_nodes: dict[str, int] = {}
        for t_ in self._running.values():
            by_type[t_.type] = by_type.get(t_.type, 0) + 1
            for n in t_.nodes:
                busy_nodes[n] = busy_nodes.get(n, 0) + 1
        self._queue.sort(key=lambda t_: (t_.priority, t_.id))
        for i, task in enumerate(self._queue):
            if task.type not in policy.task_types:
                continue
            if by_type.get(task.type, 0) >= policy.per_type_concurrency:
                continue
            if any(
                busy_nodes.get(n, 0) >= policy.per_node_concurrency
                for n in task.nodes
            ):
                continue
            return self._queue.pop(i)
        return None

    def _worker(self) -> None:
        while not self._stop.is_set():
            task = None
            with self._lock:
                if self._plane.gate_reason() is None:
                    task = self._pick_locked()
                if task is None:
                    self._lock.wait(timeout=0.25)
                    continue
                task.state = T.RUNNING
                task.started = time.time()
                self._running[task.id] = task
                self._refresh_depth_locked()
            self._run(task)

    # -- execution -------------------------------------------------------

    def _degraded_target(self, task: T.MaintenanceTask) -> str | None:
        """A reason string when any target node should not be touched:
        stale telemetry (missed heartbeats / dead reporter) or an open
        circuit breaker. None when all targets look healthy."""
        telemetry = self._plane.master.telemetry
        for url in task.nodes:
            age = telemetry.age_of(url)
            if age is not None and age > telemetry.stale_after:
                return f"{url}: telemetry stale ({age:.1f}s)"
            if retry_mod.BREAKERS.state(_netloc(url)) == "open":
                return f"{url}: circuit breaker open"
        return None

    def _run(self, task: T.MaintenanceTask) -> None:
        outcome = T.FAILED
        if not self._plane.acquire_cluster_lock():
            # a shell locked between the gate check and here: put the
            # task back untouched and let the gate hold dispatch
            with self._lock:
                task.state = T.QUEUED
                task.started = 0.0
                self._running.pop(task.id, None)
                self._queue.append(task)
                self._refresh_depth_locked()
            return
        t0 = time.perf_counter()
        try:
            with tracing.start_span("maintenance", task.type) as span:
                span.attrs["volume"] = task.volume_id
                span.attrs["task_id"] = task.id
                if task.reason:
                    span.attrs["reason"] = task.reason
                try:
                    fault.point(
                        "maintenance.task.run",
                        task=task.type, volume=str(task.volume_id),
                    )
                    degraded = self._degraded_target(task)
                    if degraded is not None:
                        task.error = f"skipped: {degraded}"
                        span.attrs["skipped"] = degraded
                        outcome = T.SKIPPED
                    else:
                        self._executors[task.type](task)
                        outcome = T.COMPLETED
                except (Exception, fault.FaultInjected) as e:
                    task.error = str(e)
                    span.status = 500
                    outcome = T.FAILED
                    glog.warningf(
                        "maintenance: %s volume=%d failed: %s",
                        task.type, task.volume_id, e,
                    )
        finally:
            self._plane.release_cluster_lock()
            dt = time.perf_counter() - t0
            MAINT_TASK_SECONDS.observe(dt, task.type)
            MAINT_TASKS.inc(task.type, outcome)
            with self._lock:
                task.state = outcome
                task.finished = time.time()
                self._running.pop(task.id, None)
                self._cooldowns[task.key()] = task.finished
                # keep the cooldown map bounded: drop expired entries
                horizon = (
                    task.finished
                    - 2 * self._plane.policy.cooldown_seconds
                )
                for key in [
                    k for k, ts in self._cooldowns.items()
                    if ts < horizon
                ]:
                    del self._cooldowns[key]
                self._counters[outcome] = (
                    self._counters.get(outcome, 0) + 1
                )
                self._history.append(task.to_dict())
                self._refresh_depth_locked()
                self._lock.notify_all()

    # -- executors (ops.py building blocks) ------------------------------

    def _exec_vacuum(self, task: T.MaintenanceTask) -> None:
        policy = self._plane.policy
        master = self._plane.master
        byte_rate = int(task.detail.get(
            "bytes_per_second", policy.bytes_per_second
        ))
        threshold = float(task.detail.get(
            "garbage_threshold", policy.garbage_threshold
        ))
        # pull the volume out of write rotation for the compact window
        # exactly like the synchronous master path (topology_vacuum.go)
        layout = self._layout_of(task.volume_id)
        if layout is not None:
            layout.remove_from_writable(task.volume_id)
        try:
            res = ops.vacuum_volume(
                master.url, task.volume_id,
                garbage_threshold=threshold,
                bytes_per_second=byte_rate,
            )
        finally:
            if layout is not None:
                layout.set_volume_writable(task.volume_id)
        task.detail.update(res)

    def _layout_of(self, vid: int):
        for col in list(
            self._plane.master.topo.collections.values()
        ):
            for layout in col.layouts():
                if vid in layout.vid2location:
                    return layout
        return None

    def _take_ec_companions(
        self, task: T.MaintenanceTask
    ) -> list[T.MaintenanceTask]:
        """Drain up to ``policy.ec_batch_max - 1`` queued same-collection
        EC_ENCODE tasks into `task`'s executor slot so one
        `/admin/ec/generate_batch` encodes the whole detector batch:
        the lane-packed `write_ec_files_batch` on one card, its mesh
        branch (`parallel/ec_sharded.encode_batch_parity` shards V over
        the mesh "vol" axis) on several. Companions are moved queue→running under the
        lock; the telemetry health check then runs OUTSIDE it (matching
        `_run`'s own ordering) and unhealthy companions finalize as
        SKIPPED immediately. Nodes busy with OTHER running tasks still
        honor per_node_concurrency — but volumes of this batch may
        share a source server freely: that is the batch."""
        limit = int(self._plane.policy.ec_batch_max) - 1
        if limit <= 0:
            return []
        picked: list[T.MaintenanceTask] = []
        with self._lock:
            cap = self._plane.policy.per_node_concurrency
            busy: dict[str, int] = {}
            for r in self._running.values():
                if r.id == task.id:
                    continue
                for n in r.nodes:
                    busy[n] = busy.get(n, 0) + 1
            rest: list[T.MaintenanceTask] = []
            for t_ in self._queue:
                if (
                    len(picked) < limit
                    and t_.type == T.EC_ENCODE
                    and t_.collection == task.collection
                    and not any(
                        busy.get(n, 0) >= cap for n in t_.nodes
                    )
                ):
                    picked.append(t_)
                else:
                    rest.append(t_)
            if not picked:
                return []
            self._queue[:] = rest
            for t_ in picked:
                t_.state = T.RUNNING
                t_.started = time.time()
                self._running[t_.id] = t_
            self._refresh_depth_locked()
        healthy: list[T.MaintenanceTask] = []
        for t_ in picked:
            degraded = self._degraded_target(t_)
            if degraded is None:
                healthy.append(t_)
            else:
                t_.error = f"skipped: {degraded}"
                self._finalize_companion(t_, T.SKIPPED)
        return healthy

    def _finalize_companion(
        self, t_: T.MaintenanceTask, outcome: str
    ) -> None:
        """Terminal bookkeeping for a coalesced companion — `_run`'s
        finally block covers only the batch leader, so companions
        mirror it here (outcome metric, cooldown stamp, counters,
        history, depth gauge, worker wakeup)."""
        MAINT_TASKS.inc(t_.type, outcome)
        with self._lock:
            t_.state = outcome
            t_.finished = time.time()
            self._running.pop(t_.id, None)
            self._cooldowns[t_.key()] = t_.finished
            self._counters[outcome] = (
                self._counters.get(outcome, 0) + 1
            )
            self._history.append(t_.to_dict())
            self._refresh_depth_locked()
            self._lock.notify_all()

    def _exec_ec_encode(self, task: T.MaintenanceTask) -> None:
        companions = self._take_ec_companions(task)
        if not companions:
            ops.ec_encode_volume(
                self._plane.master.url, task.volume_id, task.collection
            )
            return
        group = [task] + companions
        vids = [t_.volume_id for t_ in group]
        for t_ in group:
            t_.detail["batched_with"] = [
                v for v in vids if v != t_.volume_id
            ]
        try:
            ops.ec_encode_batch(
                self._plane.master.url, vids, task.collection
            )
        except Exception as e:
            for t_ in companions:
                t_.error = str(e)
                self._finalize_companion(t_, T.FAILED)
            raise
        for t_ in companions:
            self._finalize_companion(t_, T.COMPLETED)

    def _exec_ec_rebuild(self, task: T.MaintenanceTask) -> None:
        present = task.detail.get("present")
        rebuilt = ops.rebuild_ec_volume(
            self._plane.master.url, task.volume_id, task.collection,
            present=set(present) if present else None,
        )
        task.detail["rebuilt"] = rebuilt

    def _exec_fix_replication(self, task: T.MaintenanceTask) -> None:
        task.detail["fixed"] = ops.fix_replication_volume(
            self._plane.master.url, task.volume_id
        )

    def _exec_balance(self, task: T.MaintenanceTask) -> None:
        task.detail["moved"] = ops.balance_step(
            self._plane.master.url
        )

    # -- views -----------------------------------------------------------

    def backlog_seconds(self) -> float:
        """Age of the oldest queued task (0 when the queue is empty) —
        the 'is the plane keeping up' signal the telemetry plane
        flags when it exceeds 3 detector intervals."""
        with self._lock:
            if not self._queue:
                return 0.0
            # task.created is a display wall epoch (it rides the
            # /cluster/maintenance JSON); backlog age shares its clock
            return time.time() - min(  # weedcheck: ignore[wall-clock-duration]
                t_.created for t_ in self._queue
            )

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def queue_view(self) -> tuple[list[dict], list[dict], list[dict]]:
        with self._lock:
            queued = sorted(
                (t_.to_dict() for t_ in self._queue),
                key=lambda d: (d["priority"], d["id"]),
            )
            running = [
                t_.to_dict() for t_ in self._running.values()
            ]
            history = list(self._history)
        return queued, running, history

    def wake(self) -> None:
        with self._lock:
            self._lock.notify_all()
