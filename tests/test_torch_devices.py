"""The device ledger's sharded seam and scaling decomposer
(``seaweedfs_tpu_torch/telemetry/devices.py``) held against the
reference's on fresh ledgers of both packages: ``observe_sharded`` rows,
busy and imbalance of one encode on 8 positions; ``stage_lanes``' lanes
``d0``–``d7`` and the stage total; ``scaling_efficiency`` and
``decompose_scaling`` equal to the reference's on the inputs of
tests/test_devices.py.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

import jax  # noqa: E402

from seaweedfs_tpu.parallel import ec_sharded as ref_sharded  # noqa: E402
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from seaweedfs_tpu.telemetry import devices as ref_devices  # noqa: E402
from seaweedfs_tpu_torch.parallel import ec_sharded, make_mesh  # noqa: E402
from seaweedfs_tpu_torch.telemetry import devices  # noqa: E402

DATA = np.random.default_rng(7).integers(0, 256, size=(4, 10, 4096),
                                         dtype=np.uint8)


@pytest.fixture
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs its 8-device host mesh")
    return make_mesh(8, devices=["cpu"] * 8), ref_make_mesh(8)


@pytest.fixture
def ledgers(monkeypatch):
    """Fresh ledgers in both packages' sharded modules."""
    port, ref = devices.DeviceLedger(), ref_devices.DeviceLedger()
    monkeypatch.setattr(ec_sharded, "LEDGER", port)
    monkeypatch.setattr(ref_sharded, "LEDGER", ref)
    return port, ref


def test_observe_sharded_rows_match_the_reference(eight, ledgers):
    mesh, ref_mesh = eight
    port, ref = ledgers
    # warm both (the reference compiles) outside the ledgers' window
    ec_sharded.encode_sharded(DATA, mesh)
    ref_sharded.encode_sharded(DATA, ref_mesh)
    snaps, walls = [], []
    for mod, m, ledger in ((ec_sharded, mesh, port),
                           (ref_sharded, ref_mesh, ref)):
        base = ledger.baseline()
        t0 = time.perf_counter()
        out = np.asarray(mod.encode_sharded(DATA, m))
        walls.append(time.perf_counter() - t0)
        snaps.append(ledger.snapshot(base))
        assert out.shape == (4, 14, 4096)
    for snap, wall in zip(snaps, walls):
        rows = snap["devices"]
        assert [r["device"] for r in rows] == [str(i) for i in range(8)]
        for r in rows:
            assert 0 < r["busy_s"] <= wall + 0.05, (r, wall)
            assert r["platform"] == "cpu"
        assert snap["totals"]["dispatches"] == 1
        assert snap["totals"]["launch_s"] > 0
        imb = snap["imbalance"]
        assert imb["max_s"] >= imb["min_s"] > 0
        assert imb["spread_s"] == pytest.approx(
            imb["max_s"] - imb["min_s"], abs=1e-5)
    keys = ("device", "dispatches", "h2d_bytes", "d2h_bytes")
    assert [{k: r[k] for k in keys} for r in snaps[0]["devices"]] == \
        [{k: r[k] for k in keys} for r in snaps[1]["devices"]]


def test_observe_sharded_without_shards_is_none():
    port, ref = devices.DeviceLedger(), ref_devices.DeviceLedger()
    assert port.observe_sharded(object()) is None
    assert ref.observe_sharded(object()) is None
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("pad_to", [None, (4, 10, 4104)])
def test_stage_lanes_label_every_position(eight, pad_to):
    """One lane ``d<position>`` a position, each with the bytes of the
    reference's lane for the same device, and a synced stage total."""
    mesh, ref_mesh = eight
    port, ref = devices.DeviceLedger(), ref_devices.DeviceLedger()
    ec_sharded.stage_lanes(DATA, mesh, pad_to=pad_to, ledger=port)
    ref_sharded.stage_lanes(DATA, ref_mesh, pad_to=pad_to, ledger=ref)
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert [lr["lane"] for lr in snap["lanes"]] == \
        [f"d{i}" for i in range(8)]
    assert [(lr["lane"], lr["bytes"], lr["chunks"]) for lr in snap["lanes"]] \
        == [(lr["lane"], lr["bytes"], lr["chunks"])
            for lr in ref_snap["lanes"]]
    assert all(lr["busy_s"] > 0 and lr["bytes"] > 0 for lr in snap["lanes"])
    assert snap["totals"]["stage_s"] > 0
    assert snap["devices"] == []


SEC = {"1": 1.32, "8": 1.38}
COMP = {"serial_host": 0.1, "launch_serialization": 0.05,
        "transfer": 0.2, "imbalance": 0.15}


@pytest.mark.parametrize("sec,comp,n", [
    pytest.param(SEC, COMP, 8, id="gap"),
    pytest.param({"1": 1.0, "8": 0.125}, COMP, 8, id="no-gap"),
    pytest.param(SEC, {}, 8, id="nothing-measured"),
    pytest.param({"1": 1.3295, "2": 1.5503, "4": 1.9014, "8": 1.3794},
                 COMP, 4, id="sweep-at-4"),
    pytest.param({"2": 1.0, "4": 0.6}, COMP, 4, id="no-t1"),
    pytest.param({"1": 0.8, "4": 0.9, "x": None}, {"transfer": None}, 4,
                 id="junk-keys"),
])
@pytest.mark.parametrize("parallelism", [None, 1, 2, 8])
def test_decompose_scaling_is_the_references(sec, comp, n, parallelism):
    got = devices.decompose_scaling(sec, comp, n, parallelism=parallelism)
    assert got == ref_devices.decompose_scaling(sec, comp, n,
                                                parallelism=parallelism)
    assert sum(got["fractions"].values()) == pytest.approx(1.0, abs=0.01)


@pytest.mark.parametrize("sec", [
    {"1": 1.3295, "2": 1.5503, "4": 1.9014, "8": 1.3794},
    {"8": 1.0},
    {"1": 2.0, "2": 1.0, "bad": 1, "4": 0},
    {},
])
@pytest.mark.parametrize("parallelism", [None, 1, 4])
def test_scaling_efficiency_is_the_references(sec, parallelism):
    assert devices.scaling_efficiency(sec, parallelism) == \
        ref_devices.scaling_efficiency(sec, parallelism)
