"""The port's leader-failover round and its filer-tier round held against
the reference's on the CPU.

The ``leader`` churn through a stub harness with a master tier: both
packages kill the same leader, log the same actions and leave the seeded
stream untouched, so the volume kills after it replay alike. Then the
leader round at the reference test's settings (``2x1x5``, 8 volumes a
server, three masters, seed 11, 2.5 s of load) in each package: both
converge with the kill landed, kill the same volume servers after the
leader, flatten to the same gated names and round kind, and the port's
round gates cleanly against its own record. Last, a port round with two
filer shards (``f2``) records ``detail.filer``; it reads the
process-wide filer-shard ledger, so it runs in a fresh interpreter. No
case asserts a wall-clock budget.

A file of its own, so that ``--dist loadfile`` puts these rounds on
another worker than ``test_torch_scale.py``'s.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.scale import churn as ref_churn  # noqa: E402
from seaweedfs_tpu.scale import round as ref_round  # noqa: E402
from seaweedfs_tpu.scale import spec as ref_spec  # noqa: E402
from seaweedfs_tpu.util import benchgate as ref_bg  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.scale import churn as port_churn  # noqa: E402
from seaweedfs_tpu_torch.scale import round as port_round  # noqa: E402
from seaweedfs_tpu_torch.scale import spec as port_spec  # noqa: E402
from seaweedfs_tpu_torch.util import benchgate as port_bg  # noqa: E402
from seaweedfs_tpu_torch.util import lockwitness as port_lw  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubMaster:
    def __init__(self):
        self.is_leader = False


class _StubMasterHarness:
    """Duck-typed ScaleHarness with a master tier: records actions, no
    real servers; a survivor wins each election at once."""

    def __init__(self, spec, n_masters=3):
        self.spec = spec
        self.down: set[int] = set()
        self.log: list[tuple] = []
        self.n_masters = n_masters
        self.masters = [_StubMaster() for _ in range(n_masters)]
        self.masters_down: set[int] = set()
        self.pulse = 0.05
        self.masters[0].is_leader = True

    def live_indices(self):
        return [i for i in range(self.spec.total_servers)
                if i not in self.down]

    def kill_volume_server(self, i):
        self.down.add(i)
        self.log.append(("kill", i))

    def restart_volume_server(self, i):
        self.down.discard(i)
        self.log.append(("restart", i))

    def kill_rack(self, rack):
        killed = [i for i in self.spec.rack_indices(rack)
                  if i not in self.down]
        self.down.update(killed)
        self.log.append(("rack", rack))
        return killed

    def current_leader_index(self):
        for i, m in enumerate(self.masters):
            if i not in self.masters_down and m.is_leader:
                return i
        return None

    def kill_master(self, i):
        self.masters_down.add(i)
        self.masters[i].is_leader = False
        self.log.append(("kill_master", i))
        for j, m in enumerate(self.masters):
            if j not in self.masters_down:
                m.is_leader = True
                break

    def restart_master(self, i):
        self.masters_down.discard(i)
        self.log.append(("restart_master", i))


def _drive_leader(churn, spec_mod, seed, pre_down):
    h = _StubMasterHarness(spec_mod.TopologySpec(2, 2, 5))
    h.masters_down.update(pre_down)
    eng = churn.ChurnEngine(h, churn.ChurnProfile("leader", interval=10),
                            seed=seed, min_live=5)
    try:
        first = eng.kill_leader()
        untouched = eng.rnd.getstate() == random.Random(seed).getstate()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and eng.new_leader_idx is None:
            time.sleep(0.01)
        for _ in range(8):
            eng._tick()
        eng.kill_random(2)
        eng.restart_random()
        second = eng.kill_leader()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and eng.new_leader_idx is None:
            time.sleep(0.01)
        return (first, second, untouched, eng.leader_kills,
                eng.new_leader_idx, h.log,
                [{k: v for k, v in a.items() if k != "t"}
                 for a in eng.actions], eng.kills)
    finally:
        eng.stop()


@pytest.mark.parametrize("pre_down", [(), (2,), (1, 2)])
@pytest.mark.parametrize("seed", [3, 6, 11])
def test_leader_churn_schedule_equal(seed, pre_down):
    want = _drive_leader(ref_churn, ref_spec, seed, pre_down)
    assert _drive_leader(port_churn, port_spec, seed, pre_down) == want
    first, _, untouched = want[:3]
    assert first is not None and untouched
    # a master already down is revived before the kill, to keep quorum
    assert want[6][0]["action"] == ("restart_master" if pre_down
                                    else "kill_leader")


def test_leader_kill_single_master_is_a_no_op():
    for churn, spec_mod in ((ref_churn, ref_spec),
                            (port_churn, port_spec)):
        h = _StubMasterHarness(spec_mod.TopologySpec(1, 1, 5), n_masters=1)
        eng = churn.ChurnEngine(h, churn.ChurnProfile("leader"), seed=3,
                                min_live=2)
        assert eng.kill_leader() is None and eng.actions == []


def _factories():
    return (threading.Lock, threading.RLock, threading.Condition)


def _reset_clients():
    for op, retry in ((ref_operation, ref_retry),
                      (port_operation, port_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


@pytest.fixture
def port_witness_kept():
    """The round installs the port's witness for itself and removes it:
    threading's factories must be exactly the ones in place before."""
    before = _factories()
    prior = port_lw._WITNESS
    yield before
    port_lw._WITNESS = prior
    assert all(a is b for a, b in zip(_factories(), before))


LEADER = dict(seed=11, pulse_seconds=0.2, churn_kind="leader",
              kill_fraction=0.1, load_seconds=2.5, load_concurrency=4,
              converge_timeout=40.0, record_hz=4.0, out=lambda *_: None)


def _volume_kills(detail):
    """The churn actions after the leader kill, stamps left out."""
    actions = detail["churn"]["actions"]
    return [(a["action"], a["servers"], a["seed"]) for a in actions
            if a["action"] not in ("kill_leader", "restart_master")]


def test_leader_round_matches_reference(tmp_path, port_witness_kept,
                                        monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    _reset_clients()
    port_json = os.fspath(tmp_path / "SCALE_leader_port.json")
    port = port_round.run_scale_round(
        spec=port_spec.TopologySpec(2, 1, 5, volumes_per_server=8,
                                    masters=3),
        device="cpu", json_path=port_json, **LEADER)
    assert all(a is b for a, b in zip(_factories(), port_witness_kept))
    _reset_clients()
    ref = ref_round.run_scale_round(
        spec=ref_spec.TopologySpec(2, 1, 5, volumes_per_server=8,
                                   masters=3),
        json_path=os.fspath(tmp_path / "SCALE_leader_ref.json"), **LEADER)
    _reset_clients()
    for result in (port, ref):
        detail = result["detail"]
        assert detail["converged"], detail["last_reasons"]
        assert detail["churn"]["kind"] == "leader"
        actions = detail["churn"]["actions"]
        assert actions and actions[0]["action"] == "kill_leader"
        fo = detail["failover"]
        assert fo["kill_landed"] and fo["masters"] == 3
        assert fo["new_leader"] is not None
        assert fo["new_leader"] != fo["killed_master"]
        assert detail["failover_converge_s"] > 0
        assert 0.0 <= detail["midfailover_failure_rate"] <= 1.0
    detail = port["detail"]
    assert detail["failover"]["ops_in_window"] > 0
    assert "raft_term" in detail["timeline"]["probes"], sorted(
        detail["timeline"]["probes"])
    # the seed's schedule: the same volume kills after the leader's (which
    # master leads is the first election's timing, not the seed's)
    assert _volume_kills(detail) == _volume_kills(ref["detail"])
    assert _volume_kills(detail), "the round killed no volume server"
    assert (sorted(port_bg.flatten_scale(port))
            == sorted(ref_bg.flatten_scale(ref)))
    for name in ("failover_converge_s", "midfailover_failure_rate"):
        assert f"detail.{name}" in port_bg.flatten_scale(port)
    assert port_bg.round_kind(port) == ref_bg.round_kind(ref)
    with open(port_json) as f:
        stored = json.load(f)
    assert stored["detail"]["failover"]["kill_landed"]
    assert port_round.run_check(port, port_json, out=lambda *_: None) == 0


_FILER_ROUND = """\
import json, sys
from seaweedfs_tpu_torch.scale import round as rnd
from seaweedfs_tpu_torch.scale.harness import ScaleHarness


class Seeded(ScaleHarness):
    # metadata traffic on every shard, through the tier's own ring
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        ring = self.filer_ring()
        for b in ("alpha", "bravo", "charlie", "echo"):
            for i in range(5):
                ring.request("POST", f"/buckets/{b}/o{i}", b"x" * i)


rnd.ScaleHarness = Seeded
result = rnd.run_scale_round(
    spec="1x1x3f2", seed=4, pulse_seconds=0.2, churn_kind="flat",
    kill_fraction=0.0, load_seconds=1.0, load_concurrency=2,
    converge_timeout=30.0, record_hz=0, device="cpu",
    json_path=sys.argv[1], out=lambda *_: None)
print(json.dumps({"converged": result["detail"]["converged"],
                  "filer": result["detail"].get("filer"),
                  "spec": result["detail"].get("spec")}))
"""


def test_filer_shard_round_records_its_tier(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SEAWEEDFS_LOAD_JSON=str(tmp_path / "none.json"))
    p = subprocess.run(
        [sys.executable, "-c", _FILER_ROUND,
         str(tmp_path / "SCALE_f2.json")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["converged"]
    filer = got["filer"]
    assert filer["shard_count"] == 2
    assert sorted(filer["shards"]) == ["shard0", "shard1"]
    assert all(sec["ops"] > 0 for sec in filer["shards"].values())
    assert filer["meta_ops_s"] >= 0
