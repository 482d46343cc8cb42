"""The port's cluster telemetry plane (``telemetry/{slow,snapshot,
aggregator}.py``) held against the reference on the CPU.

Each case of the reference's ``tests/test_telemetry.py`` units —
``TestSnapshotUnits``, ``TestSlowLedger``, ``TestAggregator``,
``TestFleetEcTelemetry`` and ``TestHistogramConsistency`` — runs the
same inputs through both packages, each on a fresh span histogram and
error counter, and the answers must be equal (wall and monotonic times
masked). Then a port volume server's heartbeat snapshot goes into a
reference master's aggregator, and a reference server's into a port
master's: each view carries the other package's row, with the fleet EC
bytes of a generate on that server.
"""

import json
import re
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import tracing as ref_tracing  # noqa: E402
from seaweedfs_tpu.server.master import (  # noqa: E402
    MasterServer as RefMasterServer,
)
from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolumeServer,
)
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import aggregator as ref_agg  # noqa: E402
from seaweedfs_tpu.telemetry import slow as ref_slow  # noqa: E402
from seaweedfs_tpu.telemetry import snapshot as ref_snap  # noqa: E402
from seaweedfs_tpu.tracing import recorder as ref_recorder  # noqa: E402
from seaweedfs_tpu.scale import converge as ref_converge  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import telemetry as port_telemetry  # noqa: E402
from seaweedfs_tpu_torch import tracing as port_tracing  # noqa: E402
from seaweedfs_tpu_torch.server.master import (  # noqa: E402
    MasterServer as PortMasterServer,
)
from seaweedfs_tpu_torch.server.volume import (  # noqa: E402
    VolumeServer as PortVolumeServer,
)
from seaweedfs_tpu_torch.stats import metrics as port_metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import aggregator as port_agg  # noqa: E402
from seaweedfs_tpu_torch.telemetry import slow as port_slow  # noqa: E402
from seaweedfs_tpu_torch.telemetry import snapshot as port_snap  # noqa: E402
from seaweedfs_tpu_torch.tracing import recorder as port_recorder  # noqa: E402
from seaweedfs_tpu_torch.scale import converge as port_converge  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SEED = 23
PKGS = {
    "ref": (ref_snap, ref_agg, ref_slow, ref_tracing, ref_recorder,
            ref_metrics),
    "port": (port_snap, port_agg, port_slow, port_tracing, port_recorder,
             port_metrics),
}
# wall and monotonic stamps, process and link state: never compared
VOLATILE = {"time", "received_at", "age_seconds", "interval_seconds",
            "uptime_seconds", "process", "codec", "url"}


@pytest.fixture
def fresh(monkeypatch):
    """A fresh span histogram and error counter for each package, in
    place of the families its recorder feeds and its collector reads,
    and fresh persona and filer-shard ledgers."""
    for snap, _agg, _slow, _tr, rec, metrics in PKGS.values():
        monkeypatch.setattr(snap, "PROTOCOLS", snap.ProtocolAccounting())
        monkeypatch.setattr(snap, "FILER_SHARDS",
                            snap.FilerShardAccounting())
        reg = metrics.Registry()
        hist = reg.histogram(rec.SPAN_SECONDS.name, "t",
                             ("component", "op"))
        errs = reg.counter(rec.SPAN_ERRORS.name, "t", ("component", "class"))
        for mod in (snap, rec):
            monkeypatch.setattr(mod, "SPAN_SECONDS", hist)
            monkeypatch.setattr(mod, "SPAN_ERRORS", errs)
    yield


def _mask(obj):
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _finish(tracing, component, op, seconds, status=200):
    """One finished span of ``seconds``, as the middleware would close
    it."""
    sp = tracing.Span(component, op)
    sp.status = status
    sp._t0 = time.perf_counter() - seconds
    tracing.finish(sp)


# -- TestSnapshotUnits -------------------------------------------------------


def test_bucket_quantile():
    bounds = [0.001, 0.01, 0.1, 1.0]
    rng = np.random.default_rng(SEED)
    cases = [([50, 30, 15, 5], 100, q) for q in (0.5, 0.8, 0.99)]
    cases += [([50, 30, 15, 5], 0, 0.99), ([0, 0, 0, 0], 10, 0.5)]
    for _ in range(40):
        counts = [int(c) for c in rng.integers(0, 50, 4)]
        cases.append((counts, sum(counts) + int(rng.integers(0, 3)),
                      float(rng.random())))
    for counts, total, q in cases:
        want = ref_snap.quantile(bounds, counts, total, q)
        assert port_snap.quantile(bounds, counts, total, q) == want
    assert port_snap.quantile(bounds, [50, 30, 15, 5], 100, 0.8) == 0.01
    # overflow past every finite bound clamps (JSON-safe)
    assert port_snap.quantile(bounds, [0, 0, 0, 0], 10, 0.5) == 1.0


def test_collector_carries_interval_deltas(fresh):
    got = {}
    for name, (snap, _a, _s, tracing, _r, _m) in PKGS.items():
        col = snap.TelemetryCollector("unit-test-component")
        seq = [col.collect()]
        with tracing.start_span("unit-test-component", "op"):
            pass
        seq.append(col.collect())
        for seconds in (0.0015, 0.03, 0.7):
            _finish(tracing, "unit-test-component", "op", seconds)
        seq += [col.collect(), col.collect()]
        got[name] = seq
    for seq in got.values():
        assert [s["requests"]["total"] for s in seq] == [0, 1, 4, 4]
        assert [s["requests"]["delta"] for s in seq] == [0, 1, 3, 0]
        assert seq[-1]["process"]["threads"] >= 1
        assert seq[-1]["process"]["rss_bytes"] > 0
    for i, (p, r) in enumerate(zip(got["port"], got["ref"])):
        assert sorted(p) == sorted(r), i
        p_req, r_req = dict(p["requests"]), dict(r["requests"])
        # spans timed by the clock: their mean agrees to the jitter
        assert abs(p_req.pop("mean_seconds")
                   - r_req.pop("mean_seconds")) < 0.005
        assert p_req == r_req, i
        assert p["component"] == "unit-test-component"


def test_error_rate_counts_5xx_only(fresh):
    got = {}
    for name, (snap, _a, _s, tracing, _r, _m) in PKGS.items():
        col = snap.TelemetryCollector("unit-err-component")
        _finish(tracing, "unit-err-component", "op", 0.01, status=404)
        _finish(tracing, "unit-err-component", "op", 0.01, status=503)
        got[name] = col.collect()["requests"]
    # spans timed by the clock: their mean agrees to the jitter
    assert abs(got["port"].pop("mean_seconds")
               - got["ref"].pop("mean_seconds")) < 0.005
    assert got["port"] == got["ref"]
    assert got["port"]["errors"] == 1 and got["port"]["errors_4xx"] == 1
    assert got["port"]["error_rate"] == 0.5


def test_snapshot_sections_match(fresh, monkeypatch):
    """Every section of a snapshot, with the EC ledger fed, the same
    breakers tripped and the same faults counted."""
    got = {}
    for name, (snap, _a, slow, *_rest) in PKGS.items():
        retry = {"ref": ref_retry, "port": port_retry}[name]
        monkeypatch.setattr(retry, "BREAKERS",
                            retry.CircuitBreakerRegistry())
        monkeypatch.setattr(slow, "LEDGER", slow.SlowLedger())
        monkeypatch.setattr(snap, "fault_counts",
                            lambda: {"volume.read/error": 2.0})
        col = snap.TelemetryCollector("volume", url="v1")
        col.ec.record({"wall_seconds": 2.0,
                       "phases": {"read": {"bytes": 1_000_000}}},
                      volumes=2)
        for _ in range(5):
            retry.BREAKERS.record("127.0.0.1:9", ok=False)
        slow.LEDGER.offer({"duration": 1.25, "op": "write"})
        got[name] = col.collect()
    assert sorted(got["port"]) == sorted(got["ref"])
    assert _mask(got["port"]) == _mask(got["ref"])
    assert got["port"]["ec"] == {"bytes": 1_000_000, "busy_seconds": 2.0,
                                 "volumes": 2, "encodes": 1}
    assert got["port"]["slow_worst_seconds"] == 1.25


def test_protocol_and_filer_shard_ledgers():
    """The persona and filer-shard ledgers the snapshot reads: the same
    sections from the same operations, unknown names dropped."""
    got = {}
    for name, (snap, *_rest) in PKGS.items():
        protos, shards = snap.ProtocolAccounting(), \
            snap.FilerShardAccounting()
        assert protos.section() is None and shards.section() is None
        for i, (proto, sec, ok) in enumerate(
                [("native", 0.01, True), ("s3", 0.5, False),
                 ("native", 0.03, True), ("bogus", 1.0, True),
                 ("fuse", 0.002, True), ("native", 0.02, False)]):
            protos.record(proto, sec, ok)
            shards.record(f"shard{i % 3}", sec, ok)
        shards.record("shard64", 1.0)  # past the closed enum
        got[name] = (protos.section(), shards.section())
    assert got["port"] == got["ref"]
    assert sorted(got["port"][0]) == ["fuse", "native", "s3"]
    assert got["port"][0]["native"]["errors"] == 1
    assert sorted(got["port"][1]) == ["shard0", "shard1", "shard2"]


# -- TestSlowLedger ----------------------------------------------------------


def test_slow_ledger_keeps_the_n_slowest():
    rng = np.random.default_rng(SEED)
    durations = [float(d) for d in rng.random(40)]
    got = {}
    for name, (_sn, _a, slow, *_rest) in PKGS.items():
        ledger = slow.SlowLedger(capacity=4)
        entered = [ledger.offer({"duration": d, "op": f"op{i}"})
                   for i, d in enumerate(durations)]
        entered.append(ledger.offer({"duration": 0.0001, "op": "fast"}))
        floor = slow.SlowLedger(capacity=4, floor_seconds=0.5)
        entered += [floor.offer({"duration": d}) for d in durations[:8]]
        got[name] = (entered, ledger.entries(), ledger.entries(limit=2),
                     floor.entries())
    assert got["port"] == got["ref"]
    assert [e["op"] for e in got["port"][1]] == [
        f"op{i}" for i in np.argsort(durations)[::-1][:4]]
    assert port_telemetry.LEDGER is port_slow.LEDGER


def test_offer_span_carries_trace_and_fault_tags():
    got = {}
    for name, (_sn, _a, slow, tracing, *_rest) in PKGS.items():
        ledger = slow.SlowLedger(capacity=2)
        sp = tracing.Span("volume", "write")
        sp.duration = 1.5
        sp.status = 200
        sp.attrs["peer"] = "127.0.0.1:9"
        sp.attrs["fault.point"] = "volume.replicate.send"
        sp.attrs["fault.kind"] = "latency"
        assert ledger.offer_span(sp)
        [e] = ledger.entries()
        assert e["trace_id"] == sp.trace_id
        assert e["span_id"] == sp.span_id
        got[name] = {k: v for k, v in e.items()
                     if k not in ("trace_id", "span_id", "start")}
    assert got["port"] == got["ref"]
    assert got["port"]["faults"]["fault.point"] == "volume.replicate.send"


# -- TestAggregator ----------------------------------------------------------


def _both(**kw):
    return {name: pkg[1].ClusterTelemetry(**kw) for name, pkg in PKGS.items()}


def _views(aggs, **kw):
    return {name: agg.view(**kw) for name, agg in aggs.items()}


def test_slo_burn_and_staleness(fresh):
    aggs = _both(slo_error_rate=0.01, slo_p99_seconds=0.5, stale_after=0.05)
    snap = {
        "component": "volume", "url": "v1",
        "requests": {
            "total": 100, "delta": 100, "errors": 5,
            "error_delta": 5, "error_rate": 0.05,
            "window_total": 100, "p99_seconds": 1.0,
        },
    }
    for agg in aggs.values():
        agg.ingest(dict(snap))
    views = _views(aggs)
    assert _mask(views["port"]) == _mask(views["ref"])
    view = views["port"]
    assert not view["healthy"] and view["slo"]["burning"]
    assert view["slo"]["error_burn"] > 1 and view["slo"]["p99_burn"] > 1
    [srv] = view["servers"]
    assert set(srv["degraded"]) == {"error-rate", "p99"}
    # per-read override can relax the objectives
    ok = _views(aggs, slo_error_rate=0.5, slo_p99_seconds=10.0)
    assert _mask(ok["port"]) == _mask(ok["ref"])
    assert not ok["port"]["slo"]["burning"]
    time.sleep(0.08)
    stale = _views(aggs)
    assert _mask(stale["port"]) == _mask(stale["ref"])
    assert "stale" in stale["port"]["servers"][0]["degraded"]
    for name, agg in aggs.items():
        assert agg.age_of("v1") > 0.05 and agg.age_of("v2") is None
        agg.forget("v1")
        assert agg.view()["servers"] == []


class _Clock:
    """A monotonic clock the test moves by hand, in place of the
    ``time`` module a collector reads its window from."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return time.time()


@pytest.mark.parametrize("errors", [False, True],
                         ids=["slow-burst", "error-burst"])
def test_idle_server_judged_on_its_window(fresh, monkeypatch, errors):
    """A burst of requests over the p99 objective, then the server idle
    past ``window_seconds``: the port's view reads it healthy on latency,
    where the reference's keeps the lifetime p99 and marks it degraded.
    While the burst is in the window both mark it. A burst of 5xx keeps
    its error-rate mark in the reference's, idle or not; the port's
    reports an idle interval's error rate as 0 and drops the mark, and
    the rollup, which reads the servers' lifetime counts when no
    interval holds a request, burns in both."""
    clock = _Clock()
    views = {}
    for name, (snap, agg_mod, _s, tracing, _r, _m) in PKGS.items():
        monkeypatch.setattr(snap, "time", clock)
        clock.now = 1000.0
        # a component of its own: spans also reach process-wide
        # ledgers that later tests read
        col = snap.TelemetryCollector("unit-idle-component", url="v1",
                                      window_seconds=30.0)
        agg = agg_mod.ClusterTelemetry(slo_error_rate=0.01,
                                       slo_p99_seconds=0.05,
                                       stale_after=60.0)
        agg.ingest(col.collect())  # the baseline scrape
        for i in range(40):
            _finish(tracing, "unit-idle-component", "op", 0.2,
                    status=503 if errors and i % 4 == 0 else 200)
        clock.now += 5.0
        busy = col.collect()
        agg.ingest(busy)
        views[name, "busy"] = agg.view()
        clock.now += 31.0  # past the window, no request since
        idle = col.collect()
        agg.ingest(idle)
        views[name, "idle"] = agg.view()
        assert busy["requests"]["window_total"] == 40
        assert idle["requests"]["window_total"] == 0
        # the snapshot keeps the lifetime p99 for display
        assert idle["requests"]["p99_seconds"] > 0.05
    busy_marks = {"p99", "error-rate"} if errors else {"p99"}
    for name in PKGS:
        [srv] = views[name, "busy"]["servers"]
        assert set(srv["degraded"]) == busy_marks
        assert not views[name, "busy"]["healthy"]
    # spans timed by the clock: compare the judgement, not the means
    for key in ("healthy", "slo"):
        assert views["port", "busy"][key] == views["ref", "busy"][key]
    [ref_idle] = views["ref", "idle"]["servers"]
    [port_idle] = views["port", "idle"]["servers"]
    assert "p99" in ref_idle["degraded"]
    assert views["ref", "idle"]["slo"]["p99_burn"] > 1
    assert "p99" not in port_idle["degraded"]
    assert views["port", "idle"]["slo"]["p99_seconds"] == 0.0
    # an idle interval has no error rate, where the reference keeps the
    # lifetime rate
    assert "error-rate" not in port_idle["degraded"]
    assert port_idle["requests"]["error_rate"] == 0.0
    assert ("error-rate" in ref_idle["degraded"]) == errors
    assert views["port", "idle"]["healthy"] is (not errors)
    assert (views["port", "idle"]["slo"]["error_burn"]
            == views["ref", "idle"]["slo"]["error_burn"])


def test_one_slow_answer_holds_a_round_for_the_window(fresh, monkeypatch):
    """What held the port's leader round past its convergence in one CPU
    run (``tests/test_torch_scale_leader.py``): one volume server's
    answers ended together 2.11-2.16 s after they began, over the 2.0 s
    `p99` objective. In both packages one such answer among a busy
    server's fast ones marks its `p99`, and ``scale/converge.check_view``
    holds the round unconverged on it, until the answer leaves the 30 s
    window: a round whose slow answer lands in the last 10 s before its
    40 s convergence wait ends does not converge in it."""
    clock = _Clock()
    component = "unit-one-slow"
    # breakers other tests left open would ride the snapshot
    for retry in (ref_retry, port_retry):
        retry.BREAKERS.reset()
    for name, (snap, agg_mod, _s, tracing, _r, _m) in PKGS.items():
        converge = ref_converge if name == "ref" else port_converge
        monkeypatch.setattr(snap, "time", clock)
        clock.now = 1000.0
        col = snap.TelemetryCollector(component, url="v1",
                                      window_seconds=30.0)
        agg = agg_mod.ClusterTelemetry(slo_error_rate=0.01,
                                       slo_p99_seconds=2.0,
                                       stale_after=600.0)
        agg.ingest(col.collect())  # the baseline scrape
        for _ in range(40):
            _finish(tracing, component, "write", 0.01)
        _finish(tracing, component, "write", 2.156)
        reasons = {}
        # polls 1, 29 and 32 s after the slow answer (its collect at 1 s
        # starts its 30 s), each interval busy with fast answers
        for at in (1.0, 29.0, 32.0):
            clock.now = 1000.0 + at
            for _ in range(5):
                _finish(tracing, component, "write", 0.01)
            agg.ingest(col.collect())
            reasons[at] = converge.check_view(agg.view())
        mark = f"degraded {component}@v1: p99"
        assert mark in reasons[1.0], (name, reasons)
        assert mark in reasons[29.0], (name, reasons)
        assert reasons[32.0] == [], (name, reasons)


def test_idle_error_rate_is_the_intervals(fresh, monkeypatch):
    """47 answers and one 5xx (a shard copy from a killed peer), then
    the server idle: the interval that holds them reads their error
    rate and the view marks it, in both packages; an idle interval
    reads 0 in the port's and the mark goes, inside the p99 window or
    past it, where the reference's reports the lifetime rate and keeps
    the mark for ever."""
    clock = _Clock()
    rows = {}
    for name, (snap, agg_mod, _s, tracing, _r, _m) in PKGS.items():
        monkeypatch.setattr(snap, "time", clock)
        clock.now = 1000.0
        col = snap.TelemetryCollector("unit-idle-errors", url="v1",
                                      window_seconds=30.0)
        agg = agg_mod.ClusterTelemetry(slo_error_rate=0.01,
                                       slo_p99_seconds=10.0,
                                       stale_after=600.0)
        col.collect()  # the baseline scrape
        for i in range(48):
            _finish(tracing, "unit-idle-errors", "op", 0.01,
                    status=500 if i == 47 else 200)
        rows[name] = []
        for step in (5.0, 5.0, 31.0):  # busy, idle, idle past the window
            clock.now += step
            agg.ingest(col.collect())
            [srv] = agg.view()["servers"]
            rows[name].append((srv["requests"]["error_rate"],
                               "error-rate" in srv["degraded"]))
    assert rows["ref"] == [(0.020833, True)] * 3
    assert rows["port"] == [(0.020833, True), (0.0, False), (0.0, False)]


def test_view_with_own_and_maintenance_backlog(fresh):
    """The master's own row, a maintenance backlog flag, faults by max,
    breakers open, freshest-wins protocol and filer sections, the filer
    shard map and the cached view, on both aggregators."""
    aggs = _both(stale_after=5.0, view_cache_ttl=60.0)
    own = {"component": "master", "url": "m",
           "maintenance": {"enabled": True, "interval": 0.2,
                           "backlog_seconds": 1.0},
           "faults": {"a/error": 1.0},
           "breakers": {"x:1": {"state": "open"}},
           "requests": {"total": 3, "delta": 1, "errors": 0,
                        "error_delta": 0, "error_rate": 0.0,
                        "window_total": 1, "p99_seconds": 0.01}}
    rows = [
        {"component": "volume", "url": "v1", "faults": {"a/error": 3.0},
         "protocols": {"s3": {"ops_s": 2.0}}},
        {"component": "volume", "url": "v2", "faults": {"a/error": 2.0},
         "protocols": {"s3": {"ops_s": 4.0}}},
        {"component": "filer", "url": "f1",
         "filer_shard": {"index": 1, "of": 2, "url": "f1"},
         "filer": {"shard1": {"ops_s": 1.0}}},
        {"component": "filer", "url": "f0",
         "filer_shard": {"index": 0, "of": 2, "url": "f0"}},
    ]
    for agg in aggs.values():
        for r in rows:
            agg.ingest(dict(r))
    views = _views(aggs, own=own)
    assert _mask(views["port"]) == _mask(views["ref"])
    [m] = [s for s in views["port"]["servers"] if s["component"] == "master"]
    assert m["degraded"] == ["maint-backlog"]
    assert views["port"]["faults"] == {"a/error": 3.0}
    assert views["port"]["breakers_open"] == 1
    assert views["port"]["protocols"] == {"s3": {"ops_s": 4.0}}
    assert {n: a.filer_shards() for n, a in aggs.items()} == {
        "ref": ["f0", "f1"], "port": ["f0", "f1"]}
    calls = {}
    for name, agg in aggs.items():
        first = agg.view_cached(lambda n=name: calls.setdefault(n, own))
        assert agg.view_cached(lambda: pytest.fail("cache missed")) is first
        bypass = agg.view_cached(lambda: own, slo_error_rate=0.5)
        assert bypass is not first
    assert calls == {"ref": own, "port": own}


# -- TestFleetEcTelemetry ----------------------------------------------------


def _ec_snap(url: str, nbytes: float, encodes: int = 1) -> dict:
    return {
        "component": "volume", "url": url,
        "ec": {"bytes": nbytes, "busy_seconds": 0.5,
               "volumes": encodes, "encodes": encodes},
    }


def _ec_sections(aggs):
    out = {}
    for name, agg in aggs.items():
        ec = dict(agg.view()["ec"])
        out[name] = (ec.pop("fleet_GBps") > 0, ec)
    assert out["port"] == out["ref"]
    return out["port"]


def test_accounting_folds_generate_timings():
    timing = {"op": "ec.generate", "wall_seconds": 2.0,
              "phases": {"read": {"seconds": 1.0, "count": 14,
                                  "bytes": 1_000_000}}}
    got = {}
    for name, (snap, *_rest) in PKGS.items():
        acc = snap.EcAccounting()
        assert acc.snapshot() is None  # idle server ships no section
        acc.record(timing, volumes=2)
        acc.record(timing, volumes=1)
        acc.record(None)           # failed RPC: no summary, no crash
        acc.record({"op": "x"})    # malformed: counts the encode only
        acc.record({"wall_seconds": -1, "phases": {"read": {"bytes": "z"}}})
        got[name] = acc.snapshot()
    assert got["port"] == got["ref"] == {
        "bytes": 2_000_000, "busy_seconds": 4.0, "volumes": 5,
        "encodes": 4}


def test_windowed_rate_dead_server_never_sticky():
    aggs = _both(stale_after=0.2, evict_after=0.6)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 0))
        agg.ingest(_ec_snap("v2", 0))
    time.sleep(0.05)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 1e6, encodes=2))
        agg.ingest(_ec_snap("v2", 2e6, encodes=2))
    positive, ec = _ec_sections(aggs)
    assert positive and ec["reporting"] == 2
    assert ec["bytes_total"] == 3_000_000 and ec["encodes_total"] == 4
    # v2 dies: past stale_after its last burst stops contributing
    time.sleep(0.25)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 2e6, encodes=3))
    positive, ec = _ec_sections(aggs)
    assert positive and ec["reporting"] == 1
    # past evict_after the dead server's snapshot AND samples go
    time.sleep(0.45)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 3e6, encodes=4))
    evicted = {name: agg.evict_stale() for name, agg in aggs.items()}
    assert evicted["port"] == evicted["ref"] == [("volume", "v2")]
    positive, ec = _ec_sections(aggs)
    assert ec["reporting"] == 1 and ec["bytes_total"] == 3_000_000


def test_forget_drops_rate_and_totals():
    aggs = _both(stale_after=5.0)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 0))
    time.sleep(0.02)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 1e6))
        assert agg.fleet_ec_gbps() > 0
        agg.forget("v1")
        assert agg.fleet_ec_gbps() == 0.0
    positive, ec = _ec_sections(aggs)
    assert not positive and ec["reporting"] == 0
    assert ec["encodes_total"] == 0
    text = port_metrics.REGISTRY.expose()
    assert "seaweedfs_fleet_ec_GBps 0" in text


def test_counter_reset_restart_never_negative():
    aggs = _both(stale_after=5.0)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 0))
    time.sleep(0.02)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 5e6))
        assert agg.fleet_ec_gbps() > 0
        # a restart: the cumulative counter goes backwards
        agg.ingest(_ec_snap("v1", 100))
        assert agg.fleet_ec_gbps() == 0.0
    time.sleep(0.02)
    for agg in aggs.values():
        agg.ingest(_ec_snap("v1", 200))
        assert 0.0 <= agg.fleet_ec_gbps() < 1e-3
    _ec_sections(aggs)


# -- TestHistogramConsistency ------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_inf_bucket_count_sum_consistent_under_concurrent_observe(pkg):
    reg = PKGS[pkg][5].Registry()
    h = reg.histogram("conc_seconds", "t")
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            h.observe(0.0001 * (1 + (i % 4000)))
            i += 1

    workers = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    for w in workers:
        w.start()
    try:
        for _ in range(50):
            lines = reg.expose().splitlines()
            buckets = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                       if ln.startswith("conc_seconds_bucket")]
            count = next(int(ln.rsplit(" ", 1)[1]) for ln in lines
                         if ln.startswith("conc_seconds_count"))
            # cumulative buckets are monotone and the +Inf bucket
            # equals _count on every scrape, races included
            assert buckets == sorted(buckets)
            assert buckets[-1] == count
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=5)


def test_inf_bucket_emitted_even_when_all_in_finite_buckets():
    texts = {}
    for name, pkg in PKGS.items():
        reg = pkg[5].Registry()
        reg.histogram("tiny_seconds", "t").observe(0.0001)
        texts[name] = reg.expose()
    assert texts["port"] == texts["ref"]
    assert 'tiny_seconds_bucket{le="+Inf"} 1' in texts["port"]
    assert "tiny_seconds_count 1" in texts["port"]


def test_build_info_and_uptime():
    """The reference's build-info label names; the third carries the
    port's platform, read without initializing CUDA."""
    platform = "cuda" if torch.cuda.is_available() else "cpu"
    assert port_snap.backend() == platform
    port_snap.mark_started("unit-test-role")
    ref_snap.mark_started("unit-test-role")
    text = port_metrics.REGISTRY.expose()
    assert ('seaweedfs_build_info{version="0.1.0",platform="'
            f'{sys.platform}",jax_backend="{platform}"}} 1') in text
    # the same label names as the reference's family (a process whose
    # JAX backend changed carries one line per value)
    names = {}
    for pkg, reg_text in (("port", text),
                          ("ref", ref_metrics.REGISTRY.expose())):
        names[pkg] = {tuple(re.findall(r'(\w+)="', ln))
                      for ln in reg_text.splitlines()
                      if ln.startswith("seaweedfs_build_info{")}
    assert names["port"] == names["ref"] == {("version", "platform",
                                              "jax_backend")}
    body = port_snap.metrics_response().body.decode()
    assert 'seaweedfs_server_uptime_seconds{component="unit-test-role"}' in (
        body)
    assert set(port_snap.started_components()) >= {"unit-test-role"}


# -- heartbeat snapshots across packages --------------------------------------


def _cross(master_cls, vs_cls, tmp_path):
    """A master of one package, a volume server of the other: the
    server's heartbeat snapshot in the master's ``/cluster/telemetry``,
    and the fleet EC bytes of one generate on it."""
    m = master_cls(pulse_seconds=0.2)
    m.start()
    kw = {"device": "cpu"} if vs_cls is PortVolumeServer else {}
    vs = vs_cls(m.url, [str(tmp_path)], [4], pulse_seconds=0.2, **kw)
    vs.start()
    try:
        port_http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 1})
        rng = np.random.default_rng(SEED)
        for i in range(20):
            port_http.request("POST", f"{vs.url}/1,{i + 1:x}0000abcd",
                              rng.bytes(int(rng.integers(100, 4000))))
        dat = port_http.request(
            "GET", f"{vs.url}/admin/ec/download?volume=1&ext=.dat")
        port_http.post_json(f"{vs.url}/admin/ec/generate", {"volume": 1})
        deadline = time.time() + 10
        while True:
            view = port_http.get_json(f"{m.url}/cluster/telemetry")
            rows = [s for s in view["servers"] if s.get("url") == vs.url]
            if rows and view["ec"]["bytes_total"]:
                break
            assert time.time() < deadline, view
            time.sleep(0.05)
        return view, rows[0], len(dat)
    finally:
        vs.stop()
        m.stop()
        port_retry.BREAKERS.reset()
        ref_retry.BREAKERS.reset()


@pytest.mark.parametrize("master,server", [("ref", "port"),
                                           ("port", "ref")])
def test_heartbeat_snapshot_across_packages(tmp_path, master, server):
    masters = {"ref": RefMasterServer, "port": PortMasterServer}
    servers = {"ref": RefVolumeServer, "port": PortVolumeServer}
    view, row, dat_bytes = _cross(masters[master], servers[server],
                                  tmp_path)
    assert view["components"] == ["master", "volume"]
    assert row["component"] == "volume" and row["degraded"] == []
    assert row["ec"] == {"bytes": dat_bytes, "volumes": 1, "encodes": 1,
                         "busy_seconds": row["ec"]["busy_seconds"]}
    assert view["ec"]["bytes_total"] == dat_bytes
    assert view["ec"]["encodes_total"] == 1
    # the row has every section a snapshot of the master's package has
    want = masters[master] is PortMasterServer and port_snap or ref_snap
    keys = set(want.TelemetryCollector("volume").collect())
    assert keys <= set(row)
    json.dumps(view)
