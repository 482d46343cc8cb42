"""The port's autonomous maintenance plane (``maintenance/{detector,
scheduler,plane}.py``, the master's ``/cluster/maintenance``, the shell's
``maintenance.*`` and ``cluster.health``) held against the reference on
the CPU.

(a) The reference's ``TestDetector`` cases on one synthetic topology fed
    to both packages: the same candidate lists (the clock pinned).
(b) Every case of its ``TestScheduler`` and ``TestQuietForFlag`` on both
    packages: the same decisions, queues, histories and calls.
(c) Its ``TestAutonomy`` scenario on whole clusters with no shell
    command: two full, quiet volumes EC-encoded in one coalesced batch, a
    garbage-heavy volume vacuumed, a lost replica copied back over
    ``/admin/volume_copy``, then four shards deleted and rebuilt. The
    port cluster (``device="cpu"``), a port master with its plane over
    reference volume servers, and a reference master over port servers
    each converge on the reference cluster's completed tasks and shard
    bytes, and the port cluster's shards equal the reference's
    ``write_ec_files`` of the volume as it was before the encode.
(d) The async ``/vol/vacuum`` batch with its ``?sync=1`` walk, the shell
    control surface and the backlog flag in ``cluster.health``: the same
    answers and shell lines from a port and a reference cluster, with
    server URLs and volatile times masked.
"""

import hashlib
import io
import os
import re
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import fault as ref_fault  # noqa: E402
from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu import tracing as ref_tracing  # noqa: E402
from seaweedfs_tpu.maintenance import (  # noqa: E402
    MaintenancePolicy as RefPolicy,
)
from seaweedfs_tpu.maintenance import scheduler as ref_sched  # noqa: E402
from seaweedfs_tpu.maintenance import tasks as ref_tasks  # noqa: E402
from seaweedfs_tpu.maintenance.detector import (  # noqa: E402
    Detector as RefDetector,
)
from seaweedfs_tpu.maintenance.plane import (  # noqa: E402
    MaintenancePlane as RefPlane,
)
from seaweedfs_tpu.pb import messages as ref_messages  # noqa: E402
from seaweedfs_tpu.server import harness as ref_harness  # noqa: E402
from seaweedfs_tpu.server import master as ref_master  # noqa: E402
from seaweedfs_tpu.server import volume as ref_volume  # noqa: E402
from seaweedfs_tpu.shell import command_ec as ref_command_ec  # noqa: E402
from seaweedfs_tpu.shell import (  # noqa: E402
    CommandEnv as RefCommandEnv,
    run_command as ref_run_command,
)
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
)
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import devices as ref_devices  # noqa: E402
from seaweedfs_tpu.telemetry import recorder as ref_flight  # noqa: E402
from seaweedfs_tpu.telemetry import snapshot as ref_snapshot  # noqa: E402
from seaweedfs_tpu.tracing import recorder as ref_recorder  # noqa: E402
from seaweedfs_tpu.telemetry.aggregator import (  # noqa: E402
    ClusterTelemetry as RefClusterTelemetry,
)
from seaweedfs_tpu.topology import Topology as RefTopology  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import fault as port_fault  # noqa: E402
from seaweedfs_tpu_torch import operation  # noqa: E402
from seaweedfs_tpu_torch import tracing as port_tracing  # noqa: E402
from seaweedfs_tpu_torch.maintenance import (  # noqa: E402
    MaintenancePolicy,
)
from seaweedfs_tpu_torch.maintenance import scheduler as port_sched  # noqa: E402
from seaweedfs_tpu_torch.maintenance import tasks as port_tasks  # noqa: E402
from seaweedfs_tpu_torch.maintenance.detector import Detector  # noqa: E402
from seaweedfs_tpu_torch.maintenance.plane import (  # noqa: E402
    MaintenancePlane,
)
from seaweedfs_tpu_torch.operation import client as op_client  # noqa: E402
from seaweedfs_tpu_torch.pb import messages as port_messages  # noqa: E402
from seaweedfs_tpu_torch.server import master as port_master  # noqa: E402
from seaweedfs_tpu_torch.server import volume as port_volume  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.shell import (  # noqa: E402
    CommandEnv,
    command_ec,
    run_command,
)
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
)
from seaweedfs_tpu_torch.stats import metrics as port_metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import devices as port_devices  # noqa: E402
from seaweedfs_tpu_torch.telemetry import (  # noqa: E402
    snapshot as port_snapshot,
)
from seaweedfs_tpu_torch.tracing import (  # noqa: E402
    recorder as port_recorder,
)
from seaweedfs_tpu_torch.telemetry.aggregator import (  # noqa: E402
    ClusterTelemetry,
)
from seaweedfs_tpu_torch.topology import Topology  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SEED = 31
STAMP_NS = 1_700_000_000_123_456_789
TS = "1700000000"
LOST = [0, 5, 11, 13]

PKGS = {
    "ref": types.SimpleNamespace(
        Policy=RefPolicy, tasks=ref_tasks, sched=ref_sched,
        Detector=RefDetector, Plane=RefPlane, msgs=ref_messages,
        Topology=RefTopology, Telemetry=RefClusterTelemetry,
        command_ec=ref_command_ec, tracing=ref_tracing, retry=ref_retry,
        Env=RefCommandEnv, run=ref_run_command,
        Harness=ref_harness.ClusterHarness, harness_kw={},
        Master=ref_master.MasterServer, Volume=ref_volume.VolumeServer,
        volume_kw={}),
    "port": types.SimpleNamespace(
        Policy=MaintenancePolicy, tasks=port_tasks, sched=port_sched,
        Detector=Detector, Plane=MaintenancePlane, msgs=port_messages,
        Topology=Topology, Telemetry=ClusterTelemetry,
        command_ec=command_ec, tracing=port_tracing, retry=port_retry,
        Env=CommandEnv, run=run_command,
        Harness=ClusterHarness, harness_kw={"device": "cpu"},
        Master=port_master.MasterServer, Volume=port_volume.VolumeServer,
        volume_kw={"device": "cpu"}),
}
ACCEL = dict(
    enabled=True, interval=0.4, workers=2, quiet_seconds=1.5,
    full_percent=90.0, garbage_threshold=0.3, cooldown_seconds=3.0,
    task_types=("vacuum", "ec_encode", "ec_rebuild", "fix_replication"),
)


def _wait(predicate, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _reset_client_state():
    op_client._lookup_cache.clear()
    ref_operation.client._lookup_cache.clear()
    port_retry.BREAKERS.reset()
    ref_retry.BREAKERS.reset()


def _both(fn, *args):
    """``fn`` run on each package; the answers must be equal."""
    got = {name: fn(P, *args) for name, P in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# -- (a) detector predicates on one synthetic topology -------------------------


def _topo_with(P, volumes_by_node, ec_by_node=None, limit=1000):
    topo = P.Topology(volume_size_limit=limit)
    for i, vols in enumerate(volumes_by_node):
        ec = [P.msgs.EcShardInformationMessage(**e)
              for e in (ec_by_node or {}).get(i, [])]
        hb = P.msgs.Heartbeat(
            ip="10.0.0.1", port=7000 + i, max_volume_count=10,
            volumes=[P.msgs.VolumeInformationMessage(**v) for v in vols],
            ec_shards=ec,
        )
        dn = topo.register_data_node(hb)
        topo.sync_data_node_registration(hb, dn)
        topo.sync_data_node_ec_shards(list(ec), dn)
    return topo


class _FakeMaster:
    def __init__(self, P, topo):
        self.topo = topo
        self.url = "127.0.0.1:1"
        self._lock = threading.Lock()
        self._admin_lock_holder = None
        self._admin_lock_ts = 0.0
        self.telemetry = P.Telemetry(stale_after=15.0)
        self.is_leader = True


NOW = 1_760_000_000
BITS_10 = (1 << C.DATA_SHARDS) - 1
DETECTOR_CASES = {
    "vacuum_candidate_replica_max": (
        [[{"id": 1, "size": 100, "deleted_byte_count": 50,
           "modified_at_second": NOW - 10}],
         [{"id": 1, "size": 100, "deleted_byte_count": 10,
           "modified_at_second": NOW - 10}]],
        None, 1000, {"task_types": ("vacuum",)}, [1]),
    "ec_encode_needs_full_and_quiet": (
        [[{"id": 1, "size": 960, "modified_at_second": NOW - 7200},
          {"id": 2, "size": 960, "modified_at_second": NOW},
          {"id": 3, "size": 100, "modified_at_second": NOW - 7200},
          {"id": 4, "size": 960, "modified_at_second": NOW - 7200,
           "read_only": True}]],
        None, 1000, {"task_types": ("ec_encode",)}, [1]),
    "ec_rebuild_candidate_counts_missing_shards": (
        [[], []], {0: [{"id": 7, "ec_index_bits": BITS_10}]}, 1000,
        {"task_types": ("ec_rebuild",)}, [7]),
    "ec_rebuild_full_set_no_candidate": (
        [[]], {0: [{"id": 7, "ec_index_bits": (1 << C.TOTAL_SHARDS) - 1}]},
        1000, {"task_types": ("ec_rebuild",)}, []),
    "ec_rebuild_unrecoverable_not_looped": (
        [[]], {0: [{"id": 9, "ec_index_bits": (1 << 5) - 1}]}, 1000,
        {"task_types": ("ec_rebuild",)}, []),
    "fix_replication_candidate": (
        [[{"id": 5, "size": 10, "replica_placement": 1}], []], None, 1000,
        {"task_types": ("fix_replication",)}, [5]),
    "balance_candidate_on_skew": (
        [[{"id": i, "size": 1} for i in range(1, 9)], []], None, 1000,
        {"task_types": ("balance",), "balance_skew": 0.3}, [0]),
    "balance_tight_spread": (
        [[{"id": i, "size": 1} for i in range(1, 9)], []], None, 1000,
        {"task_types": ("balance",), "balance_skew": 0.9}, []),
    "every_type_at_once": (
        [[{"id": 1, "size": 960, "deleted_byte_count": 500,
           "modified_at_second": NOW - 7200},
          {"id": 5, "size": 10, "replica_placement": 1}],
         [{"id": 1, "size": 960, "modified_at_second": NOW - 7200}]],
        {1: [{"id": 7, "ec_index_bits": BITS_10 | (1 << 12)}]}, 1000,
        {"balance_skew": 0.05}, [1, 1, 7, 5]),
}


@pytest.mark.parametrize("case", list(DETECTOR_CASES))
def test_detector_matches_reference(case, monkeypatch):
    vols, ec, limit, policy_kw, want = DETECTOR_CASES[case]
    monkeypatch.setattr(time, "time", lambda: float(NOW))

    def detect(P):
        det = P.Detector(_FakeMaster(P, _topo_with(P, vols, ec, limit)))
        return det.detect(P.Policy(full_percent=95.0, **policy_kw))

    cands = _both(detect)
    assert [c["volume_id"] for c in cands] == want
    if case == "vacuum_candidate_replica_max":
        assert cands[0]["detail"]["garbage_ratio"] == 0.5
    if case == "ec_rebuild_candidate_counts_missing_shards":
        assert cands[0]["detail"]["present"] == list(range(10))
    if case == "fix_replication_candidate":
        assert cands[0]["detail"] == {"want": 2, "have": 1}


# -- (b) scheduler behaviour, no real cluster ------------------------------------


def _plane(P, policy=None):
    return P.Plane(
        _FakeMaster(P, _topo_with(P, [[]])),
        policy or P.Policy(enabled=True, cooldown_seconds=5.0),
    )


def _sched_submit_dedupes_and_cools_down(P):
    sched = _plane(P).scheduler
    cand = {"type": "vacuum", "volume_id": 3, "nodes": ["a:1"],
            "reason": "r"}
    out = [len(sched.submit([dict(cand)]))]
    out.append(len(sched.submit([dict(cand)])))  # deduped while queued
    with sched._lock:
        task = sched._queue.pop()
        sched._cooldowns[task.key()] = time.time()
    out.append(len(sched.submit([dict(cand)])))  # cooling down
    assert out == [1, 0, 0]
    return out


def _sched_pick_respects_type_and_node_caps(P):
    plane = _plane(P, P.Policy(enabled=True, per_type_concurrency=1,
                               per_node_concurrency=1))
    sched = plane.scheduler
    sched.submit([
        {"type": "vacuum", "volume_id": 1, "nodes": ["a:1"], "reason": ""},
        {"type": "vacuum", "volume_id": 2, "nodes": ["b:1"], "reason": ""},
        {"type": "ec_encode", "volume_id": 3, "nodes": ["a:1"],
         "reason": ""},
    ])

    def pick():
        t = sched._pick_locked()
        return None if t is None else (t.type, t.volume_id)

    with sched._lock:
        first = sched._queue[0]
        picks = [pick()]
        sched._running[first.id] = first
        picks.append(pick())  # type-capped and node-capped
        plane.policy = plane.policy.merge({"per_type_concurrency": 2})
        second = next(t for t in sched._queue if t.volume_id == 2)
        picks.append(pick())
        sched._running[second.id] = second
        picks.append(pick())  # ec_encode blocked on the a:1 node cap
        del sched._running[first.id]
        picks.append(pick())
    assert picks == [("vacuum", 1), None, ("vacuum", 2), None,
                     ("ec_encode", 3)]
    return picks


def _sched_priority_orders_rebuild_before_encode(P):
    sched = _plane(P).scheduler
    sched.submit([
        {"type": "ec_encode", "volume_id": 1, "nodes": [], "reason": ""},
        {"type": "ec_rebuild", "volume_id": 2, "nodes": [], "reason": ""},
        {"type": "vacuum", "volume_id": 3, "nodes": [], "reason": ""},
        {"type": "fix_replication", "volume_id": 4, "nodes": [],
         "reason": ""},
    ])
    with sched._lock:
        order = [sched._pick_locked().type for _ in range(4)]
    assert order[0] == "ec_rebuild"
    return order


def _sched_shell_lock_gates_dispatch(P):
    plane = _plane(P)
    m = plane.master
    gates = [plane.gate_reason()]
    m._admin_lock_holder = "shell-abc"
    m._admin_lock_ts = time.monotonic()
    gates.append(plane.gate_reason())
    m._admin_lock_holder = None
    plane.pause()
    gates.append(plane.gate_reason())
    plane.resume()
    gates.append(plane.gate_reason())
    m.is_leader = False
    gates.append(plane.gate_reason())
    assert gates == [None, "shell lock held by shell-abc", "paused", None,
                     "not leader"]
    return gates


def _sched_cluster_lock_shared_and_refcounted(P):
    plane = _plane(P)
    m = plane.master
    seen = [plane.acquire_cluster_lock(), plane.acquire_cluster_lock(),
            m._admin_lock_holder]
    plane.release_cluster_lock()
    seen.append(m._admin_lock_holder)
    plane.release_cluster_lock()
    seen.append(m._admin_lock_holder)
    m._admin_lock_holder = "shell-xyz"
    m._admin_lock_ts = time.monotonic()
    seen.append(plane.acquire_cluster_lock())
    assert seen == [True, True, "maintenance-plane", "maintenance-plane",
                    None, False]
    return seen


def _sched_degraded_target_skips_task(P):
    plane = _plane(P)
    plane.master.telemetry = P.Telemetry(stale_after=0.05)
    plane.master.telemetry.ingest({"component": "volume", "url": "a:1"})
    time.sleep(0.1)  # the snapshot goes stale
    P.retry.BREAKERS.reset()
    out = []
    for nodes in (["a:1"], ["b:1"]):
        task = P.tasks.MaintenanceTask(type="vacuum", volume_id=1,
                                       nodes=nodes)
        if nodes == ["b:1"]:
            for _ in range(5):
                P.retry.BREAKERS.record("b:1", ok=False)
        with plane.scheduler._lock:
            plane.scheduler._running[task.id] = task
        plane.scheduler._run(task)
        _q, _r, history = plane.scheduler.queue_view()
        out.append((history[-1]["state"], history[-1]["error"]))
    P.retry.BREAKERS.reset()
    assert out[0][0] == "skipped" and "stale" in out[0][1]
    assert out[1] == ("skipped", "skipped: b:1: circuit breaker open")
    assert plane.scheduler.counters()["skipped"] == 2
    return [(state, re.sub(r"\(\d+\.\d+s\)", "", err))
            for state, err in out]


def _sched_ec_encode_batch_coalesces_queue(P, monkeypatch):
    plane = _plane(P, P.Policy(enabled=True, ec_batch_max=3,
                               cooldown_seconds=5.0))
    sched = plane.scheduler
    calls = {}
    monkeypatch.setattr(P.sched.ops, "ec_encode_batch",
                        lambda url, vids, coll: calls.setdefault(
                            "batch", (url, tuple(vids), coll)))
    monkeypatch.setattr(P.sched.ops, "ec_encode_volume",
                        lambda *a, **k: calls.setdefault("single", a))
    sched.submit([
        {"type": "ec_encode", "volume_id": v, "nodes": ["a:1"],
         "reason": "", "collection": "c"} for v in (1, 2, 3, 4)
    ] + [{"type": "vacuum", "volume_id": 9, "nodes": ["a:1"],
          "reason": ""}])

    def lead(vid):
        with sched._lock:
            t = next(t for t in sched._queue if t.volume_id == vid)
            sched._queue.remove(t)
            t.state = P.tasks.RUNNING
            sched._running[t.id] = t
        return t

    leader = lead(1)
    sched._exec_ec_encode(leader)
    queue, _running, history = sched.queue_view()
    t4 = lead(4)
    sched._exec_ec_encode(t4)
    out = {
        "calls": calls, "leader": leader.detail,
        "done": sorted((h["volume_id"], h["state"], h["detail"])
                       for h in history),
        "queue": sorted((q["type"], q["volume_id"]) for q in queue),
        "counters": sched.counters(), "t4": t4.detail,
        "cooldowns": sorted(sched._cooldowns),
    }
    assert calls["batch"] == ("127.0.0.1:1", (1, 2, 3), "c")
    assert calls["single"] == ("127.0.0.1:1", 4, "c")
    assert leader.detail["batched_with"] == [2, 3]
    assert out["done"] == [(2, "completed", {"batched_with": [1, 3]}),
                           (3, "completed", {"batched_with": [1, 2]})]
    assert out["queue"] == [("ec_encode", 4), ("vacuum", 9)]
    assert "batched_with" not in t4.detail
    return out


def _sched_ec_batch_skips_unhealthy_and_fails_companions(P, monkeypatch):
    plane = _plane(P, P.Policy(enabled=True, ec_batch_max=4,
                               cooldown_seconds=5.0))
    plane.master.telemetry = P.Telemetry(stale_after=0.05)
    plane.master.telemetry.ingest({"component": "volume", "url": "b:1"})
    time.sleep(0.1)  # b:1's snapshot goes stale
    sched = plane.scheduler

    def boom(url, vids, coll):
        raise RuntimeError("mesh dispatch exploded")

    monkeypatch.setattr(P.sched.ops, "ec_encode_batch", boom)
    sched.submit([
        {"type": "ec_encode", "volume_id": v, "nodes": [n], "reason": ""}
        for v, n in ((1, "a:1"), (2, "a:1"), (3, "b:1"))])
    with sched._lock:
        leader = next(t for t in sched._queue if t.volume_id == 1)
        sched._queue.remove(leader)
        leader.state = P.tasks.RUNNING
        sched._running[leader.id] = leader
    with pytest.raises(RuntimeError, match="exploded"):
        sched._exec_ec_encode(leader)
    _q, _r, history = sched.queue_view()
    done = {h["volume_id"]: (h["state"], re.sub(r"\(\d+\.\d+s\)", "",
                                                h["error"]))
            for h in history}
    assert done[3][0] == "skipped" and "stale" in done[3][1]
    assert done[2] == ("failed", "mesh dispatch exploded")
    assert sched._cooldowns[("ec_encode", 2)] > 0
    return done


def _sched_task_failure_recorded_with_span_and_cooldown(P):
    sched = _plane(P).scheduler
    task = P.tasks.MaintenanceTask(type="ec_encode", volume_id=99)
    with sched._lock:
        sched._running[task.id] = task
    sched._run(task)  # the master url is dead: the executor raises
    _q, _r, history = sched.queue_view()
    spans = [s for s in P.tracing.RECORDER.spans()
             if s.component == "maintenance" and s.op == "ec_encode"
             and s.attrs.get("volume") == 99]
    out = (history[-1]["state"], bool(history[-1]["error"]),
           sched._cooldowns[("ec_encode", 99)] > 0, spans[-1].status,
           spans[-1].attrs["task_id"] == task.id)
    assert out == ("failed", True, True, 500, True)
    return out


SCHED_CASES = {
    "submit_dedupes_and_cools_down": _sched_submit_dedupes_and_cools_down,
    "pick_respects_type_and_node_caps":
        _sched_pick_respects_type_and_node_caps,
    "priority_orders_rebuild_before_encode":
        _sched_priority_orders_rebuild_before_encode,
    "shell_lock_gates_dispatch": _sched_shell_lock_gates_dispatch,
    "cluster_lock_shared_and_refcounted":
        _sched_cluster_lock_shared_and_refcounted,
    "degraded_target_skips_task": _sched_degraded_target_skips_task,
    "task_failure_recorded_with_span_and_cooldown":
        _sched_task_failure_recorded_with_span_and_cooldown,
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_matches_reference(case):
    _both(SCHED_CASES[case])


@pytest.mark.parametrize("case", [
    _sched_ec_encode_batch_coalesces_queue,
    _sched_ec_batch_skips_unhealthy_and_fails_companions,
], ids=["ec_encode_batch_coalesces_queue",
        "ec_batch_skips_unhealthy_and_fails_companions"])
def test_scheduler_batch_matches_reference(case, monkeypatch):
    _both(case, monkeypatch)


def test_rebuild_waits_for_the_volumes_live_encode():
    """While a volume's ec_encode is queued or running, its shards are
    still being spread and the master's map shows it short: the port's
    scheduler holds an ec_rebuild of it back (the reference queues one
    and rebuilds shards the encode is still placing). Other volumes'
    rebuilds, and this one's once the encode has ended, are taken."""
    sched = _plane(PKGS["port"]).scheduler
    encode = {"type": "ec_encode", "volume_id": 7, "nodes": ["a:1"],
              "reason": ""}

    def rebuild(vid):
        return {"type": "ec_rebuild", "volume_id": vid, "nodes": ["a:1"],
                "reason": "4 of 14 shards missing",
                "detail": {"present": list(range(10))}}

    assert len(sched.submit([encode])) == 1
    assert sched.submit([rebuild(7)]) == []          # queued encode
    assert len(sched.submit([rebuild(8)])) == 1
    with sched._lock:
        task = next(t for t in sched._queue if t.type == "ec_encode")
        sched._queue.remove(task)
        sched._running[task.id] = task
    assert sched.submit([rebuild(7)]) == []          # running encode
    with sched._lock:
        del sched._running[task.id]
    assert [t.volume_id for t in sched.submit([rebuild(7)])] == [7]


def test_quiet_for_parsed_and_passed(monkeypatch):
    def run(P):
        seen = []
        monkeypatch.setattr(
            P.command_ec, "collect_volume_ids_for_ec_encode",
            lambda env, collection, full, quiet: seen.append(
                (collection, full, quiet)) or [])
        env = P.command_ec.CommandEnv("127.0.0.1:1")
        env._locked = True
        for flag in ("30m", "90s", "1h30m"):
            out = io.StringIO()
            P.command_ec.cmd_ec_encode(
                env, ["-quietFor", flag, "-collection", "c"], out)
            seen.append(out.getvalue())
        return seen

    seen = _both(run)
    assert [s[2] for s in seen[::2]] == [1800.0, 90.0, 5400.0]


def test_collect_uses_heartbeat_quiet_window(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))

    class Env:
        def data_nodes(self):
            return [{"volumes": [
                {"id": 1, "collection": "c", "modified_at_second": NOW - 7200},
                {"id": 2, "collection": "c", "modified_at_second": NOW},
                {"id": 3, "collection": "other",
                 "modified_at_second": NOW - 7200},
                {"id": 4, "collection": "c", "modified_at_second": NOW - 61},
            ]}]

    got = _both(lambda P: [
        P.command_ec.collect_volume_ids_for_ec_encode(Env(), "c", 95.0, q)
        for q in (3600.0, 60.0, 0.0)])
    assert got == [[1], [1, 4], [1, 2, 4]]


# -- (c) autonomy on whole clusters --------------------------------------------


class _Mixed:
    """A master of one package with its plane, over volume servers of
    the other, in this process: the harness's layout by hand."""

    def __init__(self, master_pkg, vs_pkg, root, policy_kw, n=3):
        M, V = PKGS[master_pkg], PKGS[vs_pkg]
        self.root = root
        self.master = M.Master(pulse_seconds=0.2, volume_size_limit_mb=1,
                               maintenance_policy=M.Policy(**policy_kw))
        self.master.start()
        self.volume_servers = []
        for i in range(n):
            d = os.path.join(root, f"vs{i}")
            os.makedirs(d)
            vs = V.Volume(self.master.url, [d], [10], pulse_seconds=0.2,
                          data_center="dc1", rack=f"rack{i % 2}",
                          **V.volume_kw)
            vs.start()
            self.volume_servers.append(vs)

    def wait_for_nodes(self, n, timeout=10.0):
        assert _wait(lambda: len(self.master.topo.data_nodes()) == n,
                     timeout)

    def stop(self):
        self.master.maintenance.stop()
        for vs in self.volume_servers:
            vs.stop()
        self.master.stop()


def _make_cluster(master_pkg, vs_pkg, root):
    if master_pkg == vs_pkg:
        P = PKGS[master_pkg]
        return P.Harness(n_volume_servers=3, volumes_per_server=10,
                         pulse_seconds=0.2, volume_size_limit_mb=1,
                         maintenance_policy=P.Policy(**ACCEL), root=root,
                         **P.harness_kw)
    return _Mixed(master_pkg, vs_pkg, root, ACCEL)


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([SEED, i]).bytes(n)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _history(m):
    return http.get_json(f"{m}/cluster/maintenance")["history"]


def _completed(m):
    return {(t["type"], t["volume_id"]) for t in _history(m)
            if t["state"] == "completed"}


def _ec_shards(m, vid, collection):
    """sid -> the hashes of every copy of that shard the master maps."""
    info = http.get_json(f"{m}/ec/lookup?volumeId={vid}")["shards"]
    out = {}
    for sid, locs in info.items():
        out[int(sid)] = sorted({_sha(http.request(
            "GET", f"{loc['url']}/admin/ec/download?volume={vid}"
            f"&collection={collection}&ext={C.to_ext(int(sid))}"))
            for loc in locs})
    return out


def _autonomy(master_pkg, vs_pkg, root, monkeypatch):
    """The staged scenario, converged by the plane alone; returns what
    the reference run is held to."""
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    c = _make_cluster(master_pkg, vs_pkg, str(root))
    obs = {}
    try:
        c.wait_for_nodes(3)
        m = c.master.url
        # hold the plane while the scenario is staged
        http.post_json(f"{m}/cluster/maintenance", {"action": "pause"})
        # both warm volumes on one server, so that no other task holds
        # the second's node when the first's encode takes it along
        for vid in (1, 2):
            http.post_json(f"{c.volume_servers[0].url}/admin/assign_volume",
                           {"volume": vid, "collection": "warm"})
        assert _wait(lambda: all(
            any(vid in dn.volumes for dn in c.master.topo.data_nodes())
            for vid in (1, 2)), 10)
        for col, repl in (("trash", "000"), ("repl", "001")):
            http.post_json(f"{m}/vol/grow?count=1&collection={col}"
                           f"&replication={repl}", {})

        def holder(vid):
            return http.get_json(
                f"{m}/dir/lookup?volumeId={vid}")["locations"][0]["url"]

        # two full volumes of seeded needles at fixed fids, one clock
        warm = {}
        for vid in (1, 2):
            url = holder(vid)
            for i in range(15):
                fid = f"{vid},{i + 1:x}{0x5eed0000 + i:08x}"
                data = _payload(100 * vid + i, 64 * 1024)
                http.request("POST", f"{url}/{fid}?ts={TS}", data)
                warm[fid] = data
            for ext in (".dat", ".idx"):
                with open(os.path.join(root, f"snap_{vid}{ext}"), "wb") as f:
                    f.write(http.request(
                        "GET", f"{url}/admin/ec/download?volume={vid}"
                        f"&collection=warm&ext={ext}"))
        # a garbage-heavy volume
        url = holder(3)
        trash = [f"3,{i + 1:x}{0x7a5b0000 + i:08x}" for i in range(10)]
        for i, fid in enumerate(trash):
            http.request("POST", f"{url}/{fid}?ts={TS}",
                         _payload(300 + i, 8000))
        for fid in trash[:7]:
            http.request("DELETE", f"{url}/{fid}")
        # a volume that loses one of its two replicas
        locs = http.get_json(f"{m}/dir/lookup?volumeId=4")["locations"]
        assert len(locs) == 2
        rfid = "4,1c0ffee0"
        http.request("POST", f"{locs[0]['url']}/{rfid}?ts={TS}",
                     b"keep me replicated")
        kept = http.request("GET", f"{locs[1]['url']}/admin/ec/download"
                                   "?volume=4&collection=repl&ext=.dat")
        http.post_json(f"{locs[0]['url']}/admin/delete_volume",
                       {"volume": 4})

        def staged():
            """The master's view holds the staged state: both warm
            volumes full (one detector round then queues both, so the
            scheduler can coalesce them) and one replica of volume 4."""
            full = 0.9 * c.master.topo.volume_size_limit
            sizes = {}
            for dn in c.master.topo.data_nodes():
                for v in list(dn.volumes.values()):
                    sizes.setdefault(v.id, []).append(v.size)
            return (all(s >= full for vid in (1, 2)
                        for s in sizes.get(vid, [0]))
                    and len(sizes.get(4, [])) == 1)

        assert _wait(staged, 10)
        # unleash the plane: no shell command from here on
        http.post_json(f"{m}/cluster/maintenance", {"action": "resume"})
        want = {("ec_encode", 1), ("ec_encode", 2), ("vacuum", 3),
                ("fix_replication", 4)}
        assert _wait(lambda: want <= _completed(m), 40), _history(m)
        view = http.get_json(f"{m}/cluster/maintenance")
        assert view["rounds"] >= 1
        obs["encode"] = sorted(
            (t["volume_id"], t["detail"].get("batched_with"))
            for t in view["history"] if t["type"] == "ec_encode")
        for vid in (1, 2):
            assert _wait(lambda vid=vid: len(http.get_json(
                f"{m}/ec/lookup?volumeId={vid}")["shards"])
                == C.TOTAL_SHARDS, 10)
        obs["shards"] = {vid: _ec_shards(m, vid, "warm") for vid in (1, 2)}
        # the lost replica is back, byte-equal, and the garbage is gone
        assert _wait(lambda: len(http.get_json(
            f"{m}/dir/lookup?volumeId=4")["locations"]) == 2, 10)
        for loc in http.get_json(f"{m}/dir/lookup?volumeId=4")["locations"]:
            assert http.request(
                "GET", f"{loc['url']}/admin/ec/download?volume=4"
                "&collection=repl&ext=.dat") == kept
            assert http.request("GET", f"{loc['url']}/{rfid}") == (
                b"keep me replicated")
        chk = http.post_json(f"{holder(3)}/admin/vacuum/check",
                             {"volume": 3})
        obs["garbage_ratio"] = chk["garbage_ratio"]
        assert chk["garbage_ratio"] < 0.01
        for i, fid in enumerate(trash[7:]):
            assert http.request("GET", f"{holder(3)}/{fid}") == _payload(
                307 + i, 8000)
        # four shards of volume 1 lost, all before the plane looks again:
        # it rebuilds them in one task
        http.post_json(f"{m}/cluster/maintenance", {"action": "pause"})
        info = http.get_json(f"{m}/ec/lookup?volumeId=1")["shards"]
        for sid in LOST:
            for loc in info[str(sid)]:
                http.post_json(f"{loc['url']}/admin/ec/delete_shards",
                               {"volume": 1, "collection": "warm",
                                "shard_ids": [sid]})
        assert _wait(lambda: len(http.get_json(
            f"{m}/ec/lookup?volumeId=1")["shards"]) == C.TOTAL_SHARDS - 4,
            10)
        http.post_json(f"{m}/cluster/maintenance", {"action": "resume"})
        assert _wait(lambda: ("ec_rebuild", 1) in _completed(m), 30), (
            _history(m))
        assert _wait(lambda: len(http.get_json(
            f"{m}/ec/lookup?volumeId=1")["shards"]) == C.TOTAL_SHARDS, 10)
        obs["rebuilt"] = {sid: h for sid, h in _ec_shards(
            m, 1, "warm").items() if sid in LOST}
        assert obs["rebuilt"] == {s: obs["shards"][1][s] for s in LOST}
        [rebuild] = [t for t in _history(m) if t["type"] == "ec_rebuild"]
        obs["rebuild_detail"] = rebuild["detail"]
        op_client._lookup_cache.clear()
        for fid, data in warm.items():
            assert operation.read_file(m, fid) == data, fid
        obs["completed"] = sorted(_completed(m))
        obs["failed"] = sorted((t["type"], t["volume_id"])
                               for t in _history(m)
                               if t["state"] != "completed")
        obs["telemetry"] = http.get_json(f"{m}/cluster/telemetry")
        obs["health"] = PKGS[master_pkg].run(
            PKGS[master_pkg].Env(m), "cluster.health")
        obs["metrics"] = http.request("GET", f"{m}/metrics").decode()
        return obs
    finally:
        c.stop()
        _reset_client_state()


@pytest.fixture(scope="module")
def reference_autonomy(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _autonomy("ref", "ref", tmp_path_factory.mktemp("ref"), mp)
    finally:
        mp.undo()


def _held_to_reference(got, want):
    for key in ("encode", "shards", "rebuilt", "rebuild_detail",
                "completed", "failed", "garbage_ratio"):
        assert got[key] == want[key], key
    assert want["encode"] == [(1, [2]), (2, [1])]
    assert all(len(h) == 1 for s in want["shards"].values()
               for h in s.values())
    assert want["rebuild_detail"]["rebuilt"] == LOST


def test_autonomy_port_cluster(reference_autonomy, tmp_path, monkeypatch):
    """The port cluster: the reference's tasks and shard bytes, the
    shards the reference's ``write_ec_files`` makes of the volumes as
    they were, a ``maintenance.<type>`` span for every task, and the
    plane in the telemetry view and ``cluster.health``."""
    got = _autonomy("port", "port", tmp_path, monkeypatch)
    _held_to_reference(got, reference_autonomy)
    for vid in (1, 2):
        base = str(tmp_path / f"snap_{vid}")
        ref_encoder.write_ec_files(base)
        for sid in range(C.TOTAL_SHARDS):
            with open(base + C.to_ext(sid), "rb") as f:
                assert got["shards"][vid][sid] == [_sha(f.read())], (vid,
                                                                     sid)
    ops_seen = {s.op for s in port_tracing.RECORDER.spans()
                if s.component == "maintenance"}
    assert {"ec_encode", "ec_rebuild", "vacuum",
            "fix_replication"} <= ops_seen
    telem = got["telemetry"]
    [master_row] = [s for s in telem["servers"]
                    if s["component"] == "master"]
    maint = master_row["maintenance"]
    assert maint["enabled"] and maint["completed"] >= 5
    vols = [s for s in telem["servers"] if s["component"] == "volume"]
    assert sum((s.get("ec") or {}).get("volumes", 0) for s in vols) == 2
    assert telem["ec"]["bytes_total"] == sum(
        os.path.getsize(tmp_path / f"snap_{vid}.dat") for vid in (1, 2))
    assert "maintenance:" in got["health"] and "completed=" in got["health"]
    assert "fleet EC:" in got["health"]
    for task in ("ec_encode", "ec_rebuild", "vacuum", "fix_replication"):
        assert re.search(
            r'seaweedfs_maintenance_tasks_total\{type="%s",'
            r'outcome="completed"\} [1-9]' % task, got["metrics"]), task


@pytest.mark.parametrize("master_pkg,vs_pkg", [("port", "ref"),
                                               ("ref", "port")],
                         ids=["port-master-ref-servers",
                              "ref-master-port-servers"])
def test_autonomy_mixed_cluster(reference_autonomy, tmp_path, monkeypatch,
                                master_pkg, vs_pkg):
    got = _autonomy(master_pkg, vs_pkg, tmp_path, monkeypatch)
    _held_to_reference(got, reference_autonomy)


# -- (d) async vacuum, the shell control surface, the backlog flag -------------


def _async_vacuum(P):
    policy = P.Policy(enabled=True, interval=30.0, workers=1,
                      cooldown_seconds=0.1, task_types=("vacuum",))
    with P.Harness(n_volume_servers=1, volumes_per_server=10,
                   pulse_seconds=0.2, maintenance_policy=policy,
                   **P.harness_kw) as c:
        c.wait_for_nodes(1)
        m = c.master.url
        assert http.post_json(f"{m}/vol/grow?count=1", {}) == {"count": 1}
        url = c.volume_servers[0].url
        fids = [f"1,{i + 1:x}{0xabc00000 + i:08x}" for i in range(10)]
        for i, fid in enumerate(fids):
            http.request("POST", f"{url}/{fid}", _payload(500 + i, 4000))
        for fid in fids[:8]:
            http.request("DELETE", f"{url}/{fid}")
        c.settle(3)
        # async: a batch id at once; progress under ?batch=
        res = http.post_json(f"{m}/vol/vacuum?garbageThreshold=0.3", {})
        batch = res["batch"]

        def batch_done():
            view = http.get_json(f"{m}/cluster/maintenance?batch={batch}")
            return any(t["state"] == "completed" and t["batch"] == batch
                       for t in view["history"])

        assert _wait(batch_done, timeout=20)
        view = http.get_json(f"{m}/cluster/maintenance?batch={batch}")
        done = [(t["type"], t["volume_id"], t["state"], t["batch"],
                 t["detail"].get("garbage_threshold"))
                for t in view["history"]]
        other = http.get_json(f"{m}/cluster/maintenance?batch=vacuum-9")
        chk = http.post_json(f"{url}/admin/vacuum/check", {"volume": 1})
        for i, fid in enumerate(fids[8:]):
            assert http.request("GET", f"{url}/{fid}") == _payload(
                508 + i, 4000)
        # ?sync=1 keeps the blocking walk
        res2 = http.post_json(
            f"{m}/vol/vacuum?garbageThreshold=0.99&sync=1", {})
    _reset_client_state()
    assert res["async"] and res["enqueued"] == [1]
    assert chk["garbage_ratio"] < 0.01
    assert "vacuumed" in res2 and "async" not in res2
    return res, done, other["history"], chk["garbage_ratio"], res2


def test_async_vacuum_batch_and_sync_fallback():
    res, done, other, _ratio, _res2 = _both(_async_vacuum)
    assert res == {"async": True, "batch": "vacuum-1", "enqueued": [1]}
    assert done == [("vacuum", 1, "completed", "vacuum-1", 0.3)]
    assert other == []


# the shell comparisons: the port's servers record no request spans
# until its tracing middleware lands, so the p99 objective is set past
# any request the reference's servers time (long-lived heartbeat
# streams included)
SLO_P99 = 3600.0


@pytest.fixture
def same_state(monkeypatch, tmp_path):
    """The same staged state for both packages' clusters: nothing that
    earlier tests in this process left in the process-wide records the
    snapshots read (request spans and errors, injected faults, persona
    and filer-shard ledgers, device ledgers, breakers), no load-round
    file for the reference master, and its lock-contention table empty,
    as with no witness installed (the port has none yet)."""
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    for snap, rec, metrics in ((ref_snapshot, ref_recorder, ref_metrics),
                               (port_snapshot, port_recorder,
                                port_metrics)):
        reg = metrics.Registry()
        hist = reg.histogram(rec.SPAN_SECONDS.name, "t",
                             rec.SPAN_SECONDS.label_names)
        errs = reg.counter(rec.SPAN_ERRORS.name, "t",
                           rec.SPAN_ERRORS.label_names)
        for mod in (snap, rec):
            monkeypatch.setattr(mod, "SPAN_SECONDS", hist)
            monkeypatch.setattr(mod, "SPAN_ERRORS", errs)
    for fault, metrics in ((ref_fault, ref_metrics),
                           (port_fault, port_metrics)):
        old = fault.FAULT_INJECTED
        monkeypatch.setattr(fault, "FAULT_INJECTED", metrics.Registry(
        ).counter(old.name, old.help, old.label_names))
    for snap in (ref_snapshot, port_snapshot):
        monkeypatch.setattr(snap, "PROTOCOLS", snap.ProtocolAccounting())
        monkeypatch.setattr(snap, "FILER_SHARDS",
                            snap.FilerShardAccounting())
    for mod in (ref_devices, port_devices):
        monkeypatch.setattr(mod, "LEDGER", mod.DeviceLedger())
    monkeypatch.setattr(ref_flight, "contention_table",
                        lambda *a, **k: [])
    _reset_client_state()


def _mask(text: str, urls) -> list[str]:
    """Shell lines with server URLs masked and the volatile numbers
    (uptimes, request counts and latencies, RSS, threads, ages, round
    counts) masked; sorted, as the server rows sort by URL."""
    out = []
    for line in text.splitlines():
        for u in urls:
            line = line.replace(u, "<url>")
        if re.match(r"(master|volume) |SLO |cluster requests:", line):
            line = re.sub(r"\d+(\.\d+)?(ms|s)?", "#", line)
        line = re.sub(r"(age|backlog|last-round|rounds)=\s*[\d.]+",
                      r"\1=#", line)
        line = re.sub(r"#\d+ ", "#id ", line)
        out.append(re.sub(r"\s+", " ", line))
    return sorted(out)


def _shell_control(P):
    policy = P.Policy(**{**ACCEL, "interval": 5.0})
    with P.Harness(n_volume_servers=1, volumes_per_server=5,
                   pulse_seconds=0.2, maintenance_policy=policy,
                   slo_p99_seconds=SLO_P99, **P.harness_kw) as c:
        c.wait_for_nodes(1)
        urls = [c.master.url] + [vs.url for vs in c.volume_servers]
        env = P.Env(c.master.url)
        lines = [P.run(env, "maintenance.status")]
        lines.append(P.run(env, "maintenance.pause"))
        assert c.master.maintenance.paused
        lines.append(P.run(env, "maintenance.status"))
        lines.append(P.run(env, "maintenance.resume"))
        assert not c.master.maintenance.paused
        lines.append(P.run(env, "maintenance.policy"))
        lines.append(P.run(env, "maintenance.policy -set quiet_seconds=2h "
                                "-set workers=3"))
        assert c.master.maintenance.policy.quiet_seconds == 7200.0
        assert c.master.maintenance.policy.workers == 3
        lines.append(P.run(env, "maintenance.run vacuum"))
        with pytest.raises(Exception) as ei:
            P.run(env, "maintenance.run frobnicate")
        assert ei.value.status == 400
        c.settle(2)
        lines.append(P.run(env, "cluster.health"))
        lines.append(P.run(env, "cluster.stats"))
    _reset_client_state()
    return [_mask(text, urls) for text in lines]


def test_shell_control_surface(same_state):
    out = _both(_shell_control)
    flat = [line for text in out for line in text]
    assert "maintenance: running · rounds=# · backlog=#s" in flat
    assert ("maintenance: paused (gated: paused) · rounds=# · backlog=#s"
            in flat)
    assert "garbage_threshold = 0.3" in flat
    assert "quiet_seconds = 7200.0" in flat and "workers = 3" in flat
    assert "nothing detected" in flat
    assert "cluster: OK · roles: master,volume" in flat


def _backlog(P):
    policy = P.Policy(enabled=True, interval=0.2, workers=1,
                      task_types=("vacuum",))
    with P.Harness(n_volume_servers=1, volumes_per_server=5,
                   pulse_seconds=0.2, maintenance_policy=policy,
                   slo_p99_seconds=SLO_P99, **P.harness_kw) as c:
        c.wait_for_nodes(1)
        m = c.master.url
        urls = [m] + [vs.url for vs in c.volume_servers]
        http.post_json(f"{m}/cluster/maintenance", {"action": "pause"})
        # a hand-planted task the paused scheduler never drains
        c.master.maintenance.scheduler.submit([{
            "type": "vacuum", "volume_id": 42, "nodes": [],
            "reason": "synthetic backlog"}])
        time.sleep(0.8)  # > 3 * interval
        telem = http.get_json(f"{m}/cluster/telemetry")
        row = next(s for s in telem["servers"]
                   if s["component"] == "master")
        out = (row["degraded"], telem["healthy"],
               _mask(P.run(P.Env(m), "cluster.health"), urls),
               _mask(P.run(P.Env(m), "maintenance.status"), urls))
    _reset_client_state()
    return out


def test_backlog_flags_degraded_in_cluster_health(same_state):
    degraded, healthy, health, status = _both(_backlog)
    assert "maint-backlog" in degraded and not healthy
    assert any("BACKLOG" in line for line in health)
    assert any("maint-backlog" in line for line in health)
    assert "queued (1):" in status
