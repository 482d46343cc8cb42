"""The port's flight recorder (``telemetry/recorder.py``) and its
lock-contention views held against the reference's on the CPU.

The ring-sampler cases of the reference's ``tests/test_recorder.py`` run
on fresh ``FlightRecorder`` instances of both packages; ``build_timeline``
and ``contention_section``/``contention_table`` of both packages take the
same frames and the same witness tables and must give equal JSON. The
contention profiler is then measured live on each package's aggregator
lock under its own witness (the reference's installed by the suite's
conftest, the port's installed here and removed again).
"""

import json
import threading
import time

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import aggregator as ref_agg  # noqa: E402
from seaweedfs_tpu.telemetry import recorder as ref_flight  # noqa: E402
from seaweedfs_tpu.util import lockwitness as ref_lw  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics as port_metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import aggregator as port_agg  # noqa: E402,E501
from seaweedfs_tpu_torch.telemetry import recorder as port_flight  # noqa: E402,E501
from seaweedfs_tpu_torch.telemetry import devices as port_devices  # noqa: E402,E501
from seaweedfs_tpu_torch.util import lockwitness as port_lw  # noqa: E402

torch.set_num_threads(2)

PKGS = {
    "ref": (ref_flight, ref_agg, ref_lw, ref_metrics),
    "port": (port_flight, port_agg, port_lw, port_metrics),
}


@pytest.fixture(params=sorted(PKGS))
def flight(request):
    return PKGS[request.param][0]


def _factories():
    return (threading.Lock, threading.RLock, threading.Condition)


@pytest.fixture
def witnessed(request):
    """(recorder module, aggregator module, witness) of one package,
    each under its own process-wide witness. The port's is installed
    for the test and removed after, leaving threading's factories and
    the port's witness as they were."""
    name = request.param
    flight, agg, lw, _metrics = PKGS[name]
    if name == "ref":
        w = lw.current()
        if w is None:
            pytest.skip("reference witness disabled "
                        "(SEAWEEDFS_LOCKWITNESS=0)")
        yield flight, agg, w
        return
    before = _factories()
    prior = lw._WITNESS
    lw._WITNESS = None
    w = lw.install()
    try:
        yield flight, agg, w
    finally:
        lw.uninstall()
        lw._WITNESS = prior
        assert all(a is b for a, b in zip(_factories(), before))


BOTH = pytest.mark.parametrize("witnessed", sorted(PKGS), indirect=True)


# -- the ring sampler --------------------------------------------------------


class TestFlightRecorder:
    def test_ring_stays_bounded_under_long_runs(self, flight):
        r = flight.FlightRecorder(capacity=16)
        for _ in range(100):
            r.sample()
        assert len(r.frames()) == 16
        assert r.state()["capacity"] == 16

    def test_timestamps_monotonic_only(self, flight):
        r = flight.FlightRecorder(capacity=64)
        for _ in range(5):
            r.sample()
        ts = [f["t"] for f in r.frames()]
        assert ts == sorted(ts)
        assert ts[-1] <= time.monotonic() + 0.01
        assert abs(ts[-1] - time.monotonic()) < 120.0

    def test_vitals_always_on(self, flight):
        f = flight.FlightRecorder(capacity=8).sample()
        assert f["rss_mb"] > 0
        assert f["threads"] >= 1
        assert f["fds"] > 0

    def test_counter_probes_become_rates(self, flight):
        r = flight.FlightRecorder(capacity=8)
        box = {"v": 0.0}
        r.register_probe("ops", lambda: box["v"], kind="counter")
        assert "ops" not in r.sample()
        box["v"] = 50.0
        time.sleep(0.02)
        assert r.sample()["ops"] > 0
        box["v"] = 10.0
        time.sleep(0.02)
        assert r.sample()["ops"] == 0.0

    def test_failing_probe_is_skipped_not_fatal(self, flight):
        r = flight.FlightRecorder(capacity=8)

        def boom():
            raise RuntimeError("probe exploded")

        r.register_probe("bad", boom)
        f = r.sample()
        assert "bad" not in f
        assert "rss_mb" in f

    def test_remove_probe_identity_matched(self, flight):
        r = flight.FlightRecorder(capacity=8)
        mine, theirs = (lambda: 1.0), (lambda: 2.0)
        r.register_probe("x", mine)
        r.register_probe("x", theirs)
        r.remove_probe("x", fn=mine)
        assert "x" in r.state()["probes"]
        r.remove_probe("x", fn=theirs)
        assert "x" not in r.state()["probes"]

    def test_attach_component_idempotent(self, flight):
        r = flight.FlightRecorder(capacity=8)
        r.attach_component("filer")
        r.attach_component("filer")
        assert r.state()["probes"].count("filer_req_hz") == 1

    def test_start_stop_lifecycle(self, flight):
        r = flight.FlightRecorder(capacity=256)
        r.start(hz=50.0)
        try:
            assert r.state()["running"]
            r.start(hz=10.0)
            assert r.state()["hz"] == 50.0
            deadline = time.monotonic() + 10.0
            while r.state()["frames"] < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            r.stop()
        assert not r.state()["running"]
        assert r.state()["frames"] > 0
        r.stop()
        cost = r.sample_cost_ms()
        assert cost["max"] >= cost["mean"] > 0

    def test_frames_window_filters(self, flight):
        r = flight.FlightRecorder(capacity=64)
        r.sample()
        cut = time.monotonic()
        time.sleep(0.01)
        r.sample()
        assert len(r.frames()) == 2
        assert len(r.frames(since=cut)) == 1
        assert len(r.frames(seconds=300.0)) == 2


def test_same_probes_same_frame_keys():
    """One probe set on a recorder of each package: the same probe
    keys in every frame and the same state, vitals' values aside."""
    got = {}
    for name, (flight, *_rest) in PKGS.items():
        r = flight.FlightRecorder(capacity=8)
        box = {"v": 0.0}
        r.register_probe("ops", lambda b=box: b["v"], kind="counter")
        r.register_probe("depth", lambda: 7.0)
        r.attach_component("volume")
        frames = []
        for v in (0.0, 10.0, 30.0):
            box["v"] = v
            time.sleep(0.01)
            frames.append(r.sample())
        got[name] = (
            [sorted(k for k in f if not k.startswith(("m.", "g.")))
             for f in frames],
            [f["depth"] for f in frames],
            r.state(),
        )
    assert got["port"] == got["ref"]


# -- timeline section --------------------------------------------------------


def _frames():
    frames = [
        {"t": 100.0 + 0.25 * i, "repair_backlog": float(i % 7),
         "heartbeat_hz": 5.0 + (i % 3) / 3.0}
        for i in range(200)
    ]
    frames[137]["repair_backlog"] = 40.0
    for f in frames[50:90]:
        f["fleet_ec_gbps"] = 1.5 + f["t"] / 1000.0
    return frames


class TestTimeline:
    def test_build_timeline_spike_survives_downsample(self, flight):
        tl = flight.build_timeline(_frames(), hz=4.0, buckets=60,
                                   costs={"mean": 0.1, "max": 0.2})
        assert tl["frames"] == 200
        assert tl["hz"] == 4.0
        assert abs(tl["span_seconds"] - 199 * 0.25) < 0.01
        probe = tl["probes"]["repair_backlog"]
        assert probe["peak"] == 40.0
        assert len(probe["series"]) <= 60
        assert 40.0 in probe["series"]
        assert tl["peaks"]["repair_backlog"] == 40.0
        assert tl["sample_cost_ms"]["mean"] == 0.1

    def test_empty_and_single_frame(self, flight):
        assert flight.build_timeline([])["frames"] == 0
        tl = flight.build_timeline([{"t": 1.0, "x": 2.0}])
        assert tl["span_seconds"] == 0.0
        assert tl["probes"]["x"]["peak"] == 2.0

    @pytest.mark.parametrize("buckets", [1, 7, 60, 500])
    def test_equal_json(self, buckets):
        frames = _frames()
        got = [json.dumps(f.build_timeline(frames, hz=2.0, buckets=buckets,
                                           costs={"mean": 0.3,
                                                  "max": 0.9}),
                          sort_keys=True)
               for f in (ref_flight, port_flight)]
        assert got[0] == got[1]


# -- contention views on the same tables -------------------------------------


class _TableWitness:
    """A witness stand-in serving a fixed contention table."""

    def __init__(self, table):
        self.table = table

    def contention_snapshot(self):
        return json.loads(json.dumps(self.table))


def _site(acquires, blocked, waits, holds, kind="Lock", stack=""):
    buckets = [0] * ref_lw.WAIT_BUCKET_COUNT
    for w in waits:
        i = 0
        while (w > ref_lw.WAIT_BOUNDS[i]
               and i < ref_lw.WAIT_BUCKET_COUNT - 1):
            i += 1
        buckets[i] += 1
    return {"acquires": acquires, "blocked": blocked,
            "wait_sum": sum(waits), "wait_max": max(waits, default=0.0),
            "wait_buckets": buckets, "hold_count": len(holds),
            "hold_sum": sum(holds), "hold_max": max(holds, default=0.0),
            "blocked_stack": stack, "kind": kind, "site": "/x"}


def _tables():
    base = {
        "telemetry/aggregator.py:80": _site(10, 2, [0.001, 0.02],
                                            [0.01] * 10),
        "server/volume.py:205": _site(5, 0, [], [0.001] * 5),
    }
    cur = {
        "telemetry/aggregator.py:80": _site(
            40, 9, [0.001, 0.02, 0.03, 0.5, 2e-6, 0.004, 0.06, 0.07, 0.2],
            [0.01] * 40, stack="a.py:1:f"),
        "server/volume.py:205": _site(25, 4, [0.1, 0.2, 0.25, 0.3],
                                      [0.001] * 25, stack="v.py:2:g"),
        "topology/node.py:30": _site(300, 17, [1e-5] * 17, [1e-4] * 300,
                                     kind="RLock"),
        "maintenance/plane.py:88": _site(3, 0, [], [0.5] * 3,
                                         kind="Condition"),
    }
    return base, cur


@pytest.mark.parametrize("top", [0, 1, 3, 8])
def test_contention_views_equal_json(top):
    base, cur = _tables()
    for baseline in (None, base):
        got = []
        for f in (ref_flight, port_flight):
            w = _TableWitness(cur)
            got.append(json.dumps([
                f.contention_table(baseline=baseline, top=top, witness=w),
                f.contention_section(baseline=baseline, top=top or 8,
                                     witness=w),
                f.contention_baseline(witness=w),
            ], sort_keys=True))
        assert got[0] == got[1]


# -- contention profiler vs a deliberately contended fixture lock ------------


def _contend(tel, hold_s):
    started = threading.Event()

    def holder():
        with tel._lock:
            started.set()
            time.sleep(hold_s)

    t = threading.Thread(target=holder)
    t.start()
    started.wait(timeout=5.0)
    with tel._lock:
        pass
    t.join(timeout=5.0)


class TestContentionProfiler:
    @BOTH
    def test_contended_lock_measured(self, witnessed):
        flight, agg, w = witnessed
        tel = agg.ClusterTelemetry()
        base = flight.contention_baseline(witness=w)
        _contend(tel, 0.05)
        rows = flight.contention_table(baseline=base, witness=w)
        [row] = [r for r in rows
                 if "aggregator.py" in r["site"] and r["blocked"] >= 1]
        assert row["site"].startswith("telemetry/aggregator.py:")
        assert 0.02 < row["total_wait_s"]
        assert row["max_wait_s"] >= 0.02
        assert row["p99_wait_s"] >= 0.02
        assert row["p50_wait_s"] <= row["p99_wait_s"]
        assert row["max_hold_s"] >= 0.02
        assert row["kind"] == "Lock"
        assert row["stack"]

    @BOTH
    def test_contention_section_shape(self, witnessed):
        flight, agg, w = witnessed
        tel = agg.ClusterTelemetry()
        base = flight.contention_baseline(witness=w)
        _contend(tel, 0.02)
        sec = flight.contention_section(baseline=base, top=4, witness=w)
        assert set(sec) == {"sites", "total_wait_s", "p99_wait_s", "top"}
        assert sec["sites"] >= 1
        assert sec["total_wait_s"] > 0
        assert len(sec["top"]) <= 4
        assert sec["p99_wait_s"] == max(r["p99_wait_s"] for r in sec["top"])

    def test_sites_have_the_same_labels(self):
        """The aggregator lock's site label is the same string in both
        packages: package-relative path and the creation line."""
        labels = {}
        for name in PKGS:
            flight, agg, lw, _m = PKGS[name]
            if name == "ref":
                w = lw.current()
                if w is None:
                    pytest.skip("reference witness disabled")
                labels[name] = w.short_site(agg.ClusterTelemetry()._lock._site)
                continue
            prior = lw._WITNESS
            lw._WITNESS = None
            w = lw.install()
            try:
                tel = agg.ClusterTelemetry()
            finally:
                lw.uninstall()
                lw._WITNESS = prior
            labels[name] = w.short_site(tel._lock._site)
        assert labels["port"].split(":")[0] == labels["ref"].split(":")[0]
        assert labels["port"].startswith("telemetry/aggregator.py:")

    def test_sync_publishes_wait_histogram(self, monkeypatch):
        prior = port_lw._WITNESS
        before = _factories()
        port_lw._WITNESS = None
        w = port_lw.install()
        try:
            tel = port_agg.ClusterTelemetry()
        finally:
            port_lw.uninstall()
        try:
            reg = port_metrics.Registry()
            fam = port_flight.LOCK_WAIT_SECONDS
            monkeypatch.setattr(port_flight, "LOCK_WAIT_SECONDS",
                                reg.histogram(
                                    fam.name, "t", ("site",),
                                    start=port_lw.WAIT_BUCKET_START,
                                    factor=2.0,
                                    count=port_lw.WAIT_BUCKET_COUNT))
            monkeypatch.setattr(port_flight, "_published", {})
            _contend(tel, 0.02)
            assert port_flight.sync_lock_metrics() >= 1
            text = reg.expose()
            assert "seaweedfs_lock_wait_seconds_bucket" in text
            assert 'site="telemetry/aggregator.py' in text
            # a second sync with nothing new moves no site
            assert port_flight.sync_lock_metrics() == 0
        finally:
            port_lw._WITNESS = prior
        assert all(a is b for a, b in zip(_factories(), before))
        assert w.contention_snapshot()


def test_ledger_probes_need_a_device():
    """A recorder probe that reads the device ledger: with no card and
    no device="cpu" installing it raises; on the CPU it attaches the
    reference's probe names, and removal is identity-matched."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_devices.install_probes(n_devices=2)
    r = port_flight.FlightRecorder(capacity=8)
    probes = port_devices.install_probes(n_devices=2, recorder=r,
                                         device="cpu")
    assert [p[0] for p in probes] == [
        "dev0_busy_s", "dev1_busy_s", "device_imbalance",
        "staging_lanes_busy_s"]
    r.sample()
    assert "device_imbalance" in r.sample()
    port_devices.remove_probes(probes, recorder=r)
    assert not any(n.startswith("dev") for n in r.state()["probes"])
