"""The port's scale plane (``scale/``) held against the reference's on
the CPU.

``TopologySpec`` parsing and placement and the seeded ``ChurnEngine``
are compared over many specs and seeds. Then the warm round — the
maintenance plane EC-encodes seeded warm volumes on its own while
servers die under zipfian load — runs at ``TopologySpec(2, 1, 5)`` in
each package (the port's with ``device="cpu"``): both converge, the
port's fleet EC rate is positive, both records flatten to the same
gated metric names, and the port's round gates cleanly against its own
record. The port's warm encode is byte-identical to the reference's
``write_ec_files`` of the same ``.dat``. No case asserts a wall-clock
budget.
"""

import os
import shutil
import threading
import time

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.scale import churn as ref_churn  # noqa: E402
from seaweedfs_tpu.scale import round as ref_round  # noqa: E402
from seaweedfs_tpu.scale import spec as ref_spec  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
)
from seaweedfs_tpu.util import benchgate as ref_bg  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.scale import churn as port_churn  # noqa: E402
from seaweedfs_tpu_torch.scale import round as port_round  # noqa: E402
from seaweedfs_tpu_torch.scale import spec as port_spec  # noqa: E402
from seaweedfs_tpu_torch.scale.harness import ScaleHarness  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding.constants import (  # noqa: E402,E501
    TOTAL_SHARDS,
    to_ext,
)
from seaweedfs_tpu_torch.util import benchgate as port_bg  # noqa: E402
from seaweedfs_tpu_torch.util import lockwitness as port_lw  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SPECS = ["5x4x5", "5x4x5m3", "2x1x5", "1x1x1", "3x2x7m5", "5x4", "5x4x5m0",
         "0x1x1", "axbxc", "2x2x2x2", " 2x1x5 "]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, IndexError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("text", SPECS)
def test_spec_parse_and_placement_equal(text):
    got = {}
    for name, mod in (("ref", ref_spec), ("port", port_spec)):
        out = _outcome(mod.TopologySpec.parse, text)
        if out[0] == "ok":
            sp = out[1]
            out = (str(sp), sp.total_servers, sp.total_racks, sp.masters,
                   sp.filers, sp.volumes_per_server,
                   [sp.placement(i) for i in range(sp.total_servers)],
                   [sp.rack_indices(r) for r in range(sp.total_racks)],
                   _outcome(sp.placement, sp.total_servers))
        got[name] = out
    assert got["port"] == got["ref"]


def test_spec_constructor_checks_equal():
    for args in ((0, 1, 1), (1, 0, 1), (1, 1, 0), (2, 2, 2)):
        got = [_outcome(lambda m=mod: str(m.TopologySpec(*args)))
               for mod in (ref_spec, port_spec)]
        assert got[0] == got[1], args


class _StubHarness:
    """Duck-typed ScaleHarness: records actions, no real servers."""

    def __init__(self, spec):
        self.spec = spec
        self.down: set[int] = set()
        self.log: list[tuple] = []

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


def _drive(churn, spec_mod, kind, seed):
    h = _StubHarness(spec_mod.TopologySpec(2, 2, 5))
    eng = churn.ChurnEngine(h, churn.ChurnProfile(kind, interval=10),
                            seed=seed, min_live=5)
    for _ in range(12):
        eng._tick()
    eng.kill_random(2)
    eng.kill_rack_random()
    eng.restart_random()
    return h.log, [{k: v for k, v in a.items() if k != "t"}
                   for a in eng.actions], eng.kills


@pytest.mark.parametrize("kind", ["flat", "burst", "rolling", "warm"])
@pytest.mark.parametrize("seed", [1, 7, 11, 5])
def test_churn_kills_the_same_servers(kind, seed):
    assert port_churn.KINDS == ref_churn.KINDS
    want = _drive(ref_churn, ref_spec, kind, seed)
    assert _drive(port_churn, port_spec, kind, seed) == want
    assert want[0], "the engine killed nobody"


def test_churn_rejects_unknown_kind():
    for churn in (ref_churn, port_churn):
        with pytest.raises(ValueError):
            churn.ChurnProfile("meteor")


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
    threading's factories (the reference witness's under this suite)
    must be exactly the ones in place before."""
    before = _factories()
    prior = port_lw._WITNESS
    yield before, prior
    port_lw._WITNESS = prior
    assert all(a is b for a, b in zip(_factories(), before))


WARM = dict(seed=11, pulse_seconds=0.2, churn_kind="warm",
            kill_fraction=0.1, load_seconds=2.0, load_concurrency=4,
            converge_timeout=30.0, record_hz=4.0, out=lambda *_: None)


def test_warm_round_matches_reference(tmp_path, port_witness_kept,
                                      monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    _reset_clients()
    port_json = os.fspath(tmp_path / "SCALE_port.json")
    port = port_round.run_scale_round(
        spec=port_spec.TopologySpec(2, 1, 5, volumes_per_server=8),
        device="cpu", json_path=port_json, **WARM)
    # the round removed the witness it installed for itself
    assert all(a is b for a, b in zip(_factories(), port_witness_kept[0]))
    assert not port_lw.current().installed
    _reset_clients()
    ref = ref_round.run_scale_round(
        spec=ref_spec.TopologySpec(2, 1, 5, volumes_per_server=8),
        json_path=os.fspath(tmp_path / "SCALE_ref.json"), **WARM)
    _reset_clients()
    detail = port["detail"]
    assert detail["converged"], detail["last_reasons"]
    assert detail["churn"]["kind"] == "warm"
    assert len(detail["churn"]["killed"]) == 1
    assert detail["fleet_ec_GBps"] > 0, detail.get("fleet_ec")
    assert detail["ec_encoded_warm_volumes"] >= 1
    assert detail["fleet_ec"]["bytes_total"] > 0
    assert detail["fleet_ec"]["seeded"]["volumes"]
    assert detail["load_ops_per_second"] > 0
    # the middleware counts the master's requests now
    assert detail["master_requests_per_second"] > 0
    probes = detail["timeline"]["probes"]
    for name in ("fleet_ec_gbps", "heartbeat_hz", "repair_backlog",
                 "master_req_hz", "volume_req_hz", "fds", "threads"):
        assert name in probes, sorted(probes)
    assert set(detail["contention"]) == {"sites", "total_wait_s",
                                         "p99_wait_s", "top"}
    # the same gated metrics, by name, as the reference's round
    assert (sorted(port_bg.flatten_scale(port))
            == sorted(ref_bg.flatten_scale(ref)))
    assert port_bg.round_kind(port) == ref_bg.round_kind(ref) == "scale"
    # the seeded warm volumes are the same draw in both packages
    assert (detail["fleet_ec"]["seeded"]
            == ref["detail"]["fleet_ec"]["seeded"])
    assert port_round.run_check(port, port_json, out=lambda *_: None) == 0


def test_entry_points_raise_without_a_card(port_witness_kept):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScaleHarness(port_spec.TopologySpec(1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_round.run_scale_round(spec="1x1x1", out=lambda *_: None)
    # the device is resolved before the witness: nothing was installed
    assert port_lw.current() is port_witness_kept[1]


def test_filer_shards_raise(port_witness_kept):
    """A spec's filer shards start, one sqlite store each, and the ring
    routes over them; the S3 gateway, once it raised here, now starts
    over that ring."""
    spec = port_spec.TopologySpec(1, 1, 1, filers=2)
    harness = ScaleHarness(spec, device="cpu", with_s3=True)
    try:
        assert len(harness.filer_urls()) == 2
        assert harness.filer is harness.filers[0]
        ring = harness.filer_ring()
        assert len(ring) == 2 and ring.urls == harness.filer_urls()
        assert harness.s3.ring.urls == ring.urls
        assert {f"filer{i}.db" for i in range(2)} <= set(
            os.listdir(harness.root))
    finally:
        harness.stop()


def test_warm_encode_byte_identical_to_reference_encoder(tmp_path):
    """The port plane's autonomous warm encode against the reference's
    ``write_ec_files`` of the same ``.dat``: copy the seeded volume
    aside while the plane is paused, let it encode, spread and delete
    the original, then compare every shard."""
    _reset_clients()
    harness = ScaleHarness(
        port_spec.TopologySpec(1, 1, 2), pulse_seconds=0.2,
        maintenance_policy=port_round.scale_policy(0.2, warm=True),
        volume_size_limit_mb=1, device="cpu")
    try:
        harness.wait_for_nodes(2, timeout=30.0)
        harness.master.maintenance.pause()
        seeded = port_round.seed_warm_volumes(harness, 1, seed=7,
                                              out=lambda *_: None)
        # seeding leaves a plane its caller paused paused
        assert harness.master.maintenance.paused
        vid = seeded["volumes"][0]
        src = None
        for vs in harness.volume_servers:
            for loc in vs.store.locations:
                b = loc.base_file_name("warm", vid)
                if os.path.exists(b + ".dat"):
                    src = b
        assert src, "seeded warm volume not found on any server"
        copy = os.fspath(tmp_path / f"warm_{vid}")
        shutil.copy(src + ".dat", copy + ".dat")
        shutil.copy(src + ".idx", copy + ".idx")
        harness.master.maintenance.resume()
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            locs = harness.master.topo.ec_shard_map.get(("warm", vid))
            if locs is not None and all(locs.locations):
                break
            time.sleep(0.2)
        else:
            pytest.fail("maintenance never EC-encoded+spread the volume")
        shards: dict[int, bytes] = {}
        for vs in harness.volume_servers:
            for loc in vs.store.locations:
                b = loc.base_file_name("warm", vid)
                for i in range(TOTAL_SHARDS):
                    p = b + to_ext(i)
                    if os.path.exists(p) and i not in shards:
                        with open(p, "rb") as f:
                            shards[i] = f.read()
        assert len(shards) == TOTAL_SHARDS, sorted(shards)
        ec = {}
        while time.monotonic() < deadline:
            ec = harness.master.telemetry.view()["ec"]
            if ec.get("encodes_total"):
                break
            time.sleep(0.2)
        assert ec.get("encodes_total", 0) >= 1, ec
        assert ec["bytes_total"] > 0
    finally:
        harness.stop()
        _reset_clients()
    ref_encoder.write_ec_files(copy)
    for i in range(TOTAL_SHARDS):
        with open(copy + to_ext(i), "rb") as f:
            assert f.read() == shards[i], f"shard {i} differs"
