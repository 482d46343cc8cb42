"""The port's ``fuse`` and ``broker`` personas (``command/benchmark.py``)
and the persona round (``scale/round.py``) held against the reference's
on the CPU.

Each persona of each package runs against its own cluster, filer and
broker: a seeded op sequence driven straight through ``run`` gives the
same bytes, and a seeded one-worker ``run_benchmark`` of the persona the
same op trace and counts. ``FrontDoors`` spawns the filer and the broker
a mix needs. An injected broker 503 counts as a persona failure, never
a latency. A small round with the full persona mix in each package
gives the same gated names and the same ``detail.protocols`` sections.
Last, ``SCALE_r07.json``'s churn schedule (spec ``5x4x5m3f2``, seed 7,
churn ``leader``, 3 % killed over 20 s of load) through a stub fleet is
the reference's, and is the schedule the record holds.
"""

import json
import os
import random
import threading

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.command import benchmark as ref_bench  # noqa: E402
from seaweedfs_tpu.messaging import broker as ref_broker  # noqa: E402
from seaweedfs_tpu.scale import churn as ref_churn  # noqa: E402
from seaweedfs_tpu.scale import round as ref_round  # noqa: E402
from seaweedfs_tpu.scale import spec as ref_spec  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefHarness,
)
from seaweedfs_tpu.util import benchgate as ref_bg  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import fault as port_fault  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.command import benchmark as port_bench  # noqa: E402,E501
from seaweedfs_tpu_torch.messaging import broker as port_broker  # noqa: E402
from seaweedfs_tpu_torch.scale import churn as port_churn  # noqa: E402
from seaweedfs_tpu_torch.scale import round as port_round  # noqa: E402
from seaweedfs_tpu_torch.scale import spec as port_spec  # noqa: E402
from seaweedfs_tpu_torch.server.harness import (  # noqa: E402
    ClusterHarness as PortHarness,
)
from seaweedfs_tpu_torch.util import benchgate as port_bg  # noqa: E402
from seaweedfs_tpu_torch.util import lockwitness as port_lw  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "ref": (ref_bench, ref_broker, RefHarness, {}),
    "port": (port_bench, port_broker, PortHarness, {"device": "cpu"}),
}
MIX = "native:40,s3:30,fuse:20,broker:10"


def _reset_clients():
    for op, retry in ((ref_operation, ref_retry),
                      (port_operation, port_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


def _persona_run(name, root, persona):
    """One package's ``persona`` on its own cluster, filer and broker:
    a seeded op sequence through ``run``, then a seeded one-worker
    ``run_benchmark`` of that persona alone."""
    bench, broker_mod, harness, kw = PKG[name]
    _reset_clients()
    with harness(n_volume_servers=1, volumes_per_server=12,
                 pulse_seconds=0.2, root=str(root), with_filer=True,
                 **kw) as c:
        c.wait_for_nodes(1)
        b = broker_mod.MessageBroker(c.filer.url, flush_every=8)
        b.start()
        try:
            if persona == "fuse":
                driver = bench.FusePersona(c.filer.url, (512, 70_000), 11)
                ops, weights = ["create", "read", "unlink"], [.45, .4, .15]
            else:
                driver = bench.BrokerPersona(b.url, 11)
                ops, weights = ["publish", "subscribe"], [.65, .35]
            rnd = random.Random(11)
            direct = []
            try:
                for _ in range(40):
                    op = rnd.choices(ops, weights)[0]
                    direct.append((op, driver.run(op, rnd)))
            finally:
                driver.close()
            rc = bench.run_benchmark(
                c.master.url, n=24, concurrency=1, personas=persona,
                sizes="512-6000", seed=5, op_trace=True,
                filer_url=c.filer.url, broker_url=b.url,
                out=lambda *_: None)
        finally:
            b.stop()
    _reset_clients()
    proto = bench.LAST_RESULT["detail"]["protocols"][persona]
    return {
        "direct": direct, "rc": rc,
        "trace": [(op, ok) for _t, op, ok in
                  bench.LAST_PERSONA_TRACES[persona]],
        "counts": (proto["ops"], proto["ok"], proto["failures"]),
        "by_op": {op: (v["ops"], v["ok"], v["failures"])
                  for op, v in proto["by_op"].items()},
    }


@pytest.mark.parametrize("persona", ["fuse", "broker"])
def test_persona_schedule_matches_reference(tmp_path, persona):
    got = {name: _persona_run(name, tmp_path / name, persona)
           for name in PKG}
    assert got["port"] == got["ref"]
    run = got["port"]
    assert run["rc"] == 0 and run["counts"][2] == 0
    assert len(run["trace"]) == 24
    assert {op for op, _ in run["direct"]} == set(
        port_bench.PERSONA_MIXES[persona])


def test_front_doors_spawn_filer_and_broker(tmp_path):
    """A mix that needs the mount and the broker spawns a filer and a
    broker journaling through it; an explicit URL is used as it is."""
    with PortHarness(n_volume_servers=1, volumes_per_server=12,
                     pulse_seconds=0.2, root=str(tmp_path),
                     device="cpu") as c:
        c.wait_for_nodes(1)
        doors = port_bench.FrontDoors(c.master.url, need_fuse=True,
                                      need_broker=True)
        try:
            assert len(doors._own) == 2
            assert doors.filer_url and doors.broker_url
            out = port_bench.BrokerPersona(doors.broker_url, 3).run(
                "publish", random.Random(3))
            assert out > 0
        finally:
            doors.close()
        kept = port_bench.FrontDoors(c.master.url, need_broker=True,
                                     broker_url="http://y")
        assert (kept.broker_url, kept._own) == ("http://y", [])
    _reset_clients()


def test_broker_persona_counts_a_fault_as_failure(tmp_path):
    """The reference's ``test_broker_persona_counts_fault_as_failure``
    on the port: three injected 503s are three failures and no
    latency samples."""
    with PortHarness(n_volume_servers=1, volumes_per_server=12,
                     pulse_seconds=0.2, root=str(tmp_path),
                     device="cpu", with_filer=True) as c:
        c.wait_for_nodes(1)
        b = port_broker.MessageBroker(c.filer.url)
        b.start()
        try:
            persona = port_bench.BrokerPersona(b.url, seed=7)
            rec = port_bench._ProtocolRecorder("broker", persona)
            section = port_bench.PROTOCOLS.section() or {}
            before = (section.get("broker") or {}).get("errors", 0)
            try:
                port_fault.REGISTRY.inject(
                    "http.client.send", kind="error", status=503,
                    count=3, seed=5, peer=b.url)
                stats, _wall = port_bench._run_phase(
                    rec, {"publish": 1.0}, 12, 0.0, 2, phase_seed=99)
            finally:
                port_fault.REGISTRY.clear()
        finally:
            b.stop()
    _reset_clients()
    st = stats["publish"]
    assert st.failures == 3 and len(st.latencies_ms()) == 12 - 3
    assert port_bench.PROTOCOLS.section()["broker"]["errors"] - before == 3


def _factories():
    return (threading.Lock, threading.RLock, threading.Condition)


@pytest.fixture
def port_witness_kept():
    before = _factories()
    prior = port_lw._WITNESS
    yield before
    port_lw._WITNESS = prior
    assert all(a is b for a, b in zip(_factories(), before))


ROUND = dict(seed=13, pulse_seconds=0.2, churn_kind="flat",
             kill_fraction=0.1, load_seconds=2.5, load_concurrency=8,
             personas=MIX, converge_timeout=40.0, record_hz=4.0,
             out=lambda *_: None)


def test_persona_round_matches_reference(tmp_path, port_witness_kept,
                                         monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    _reset_clients()
    port_json = os.fspath(tmp_path / "SCALE_personas_port.json")
    port = port_round.run_scale_round(
        spec=port_spec.TopologySpec(2, 1, 5, volumes_per_server=8),
        device="cpu", json_path=port_json, **ROUND)
    _reset_clients()
    ref = ref_round.run_scale_round(
        spec=ref_spec.TopologySpec(2, 1, 5, volumes_per_server=8),
        json_path=os.fspath(tmp_path / "SCALE_personas_ref.json"), **ROUND)
    _reset_clients()
    for result in (port, ref):
        d = result["detail"]
        assert d["converged"], d["last_reasons"]
        assert d["personas"] == MIX
        assert set(d["protocols"]) == {"native", "s3", "fuse", "broker"}
        for sec in d["protocols"].values():
            assert sec["ops"] > 0 and sec["ops"] == sec["ok"] + sec[
                "failures"]
    assert (sorted(port_bg.flatten_scale(port))
            == sorted(ref_bg.flatten_scale(ref)))
    assert "protocols.fuse.error_rate" in port_bg.flatten_scale(port)
    assert port_bg.round_kind(port) == ref_bg.round_kind(ref)
    for name, sec in port["detail"]["protocols"].items():
        assert sorted(sec) == sorted(ref["detail"]["protocols"][name])
        assert sorted(sec["by_op"]) == sorted(
            ref["detail"]["protocols"][name]["by_op"])
    assert port_round.run_check(port, port_json, out=lambda *_: None) == 0


class _StubMaster:
    def __init__(self):
        self.is_leader = False


class _StubFleet:
    """A duck-typed ScaleHarness with a master tier: it records the
    churn's actions and starts nothing; a survivor leads at once."""

    def __init__(self, spec):
        self.spec = spec
        self.down: set[int] = set()
        self.log: list[tuple] = []
        self.n_masters = spec.masters
        self.masters = [_StubMaster() for _ in range(spec.masters)]
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


def _r07_schedule(churn, spec_mod):
    """The round's churn engine at ``SCALE_r07.json``'s settings, ticked
    as its interval would tick it: one leader kill, then volume kills
    up to the round's 3 % of 100."""
    spec = spec_mod.TopologySpec.parse("5x4x5m3f2")
    n = spec.total_servers
    kills = max(1, int(n * 0.03))
    interval = max(20.0 / (kills + 1), 0.2)
    fleet = _StubFleet(spec)
    eng = churn.ChurnEngine(
        fleet, churn.ChurnProfile(kind="leader", interval=interval,
                                  max_kills=kills),
        seed=7, min_live=n - kills)
    try:
        for _ in range(kills + 3):  # ticks past the cap kill nothing
            eng._tick()
        return (interval, kills, fleet.log,
                [{k: v for k, v in a.items() if k != "t"}
                 for a in eng.actions], eng.kills, eng.leader_kills)
    finally:
        eng.stop()


def test_r07_churn_schedule_matches_reference():
    got = _r07_schedule(port_churn, port_spec)
    assert got == _r07_schedule(ref_churn, ref_spec)
    with open(os.path.join(REPO, "SCALE_r07.json")) as f:
        recorded = json.load(f)["detail"]["churn"]
    interval, kills, _log, actions, n_kills, leader_kills = got
    assert interval == recorded["interval"] and kills == 3 == n_kills
    assert leader_kills == 1
    # the record's schedule, stamps aside: the same leader, the same
    # volume servers in the same order
    assert actions == [{k: v for k, v in a.items() if k != "t"}
                       for a in recorded["actions"]]
    assert sorted(s for a in actions if a["action"] == "kill"
                  for s in a["servers"]) == sorted(recorded["killed"])
