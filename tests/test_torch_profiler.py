"""The port's codec profiler and device ledger against the reference's:
the same dispatch records give identical ``seaweedfs_codec_dispatch_*``
exposition, the same ring of records, and the same ledger (the port's
``cuda`` backend where the reference has ``pallas``; the host backends
ignored on both sides)."""

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

import numpy as np  # noqa: E402

from seaweedfs_tpu import tracing as ref_tracing  # noqa: E402
from seaweedfs_tpu.ops import link as ref_link  # noqa: E402
from seaweedfs_tpu.ops import profiler as ref_profiler  # noqa: E402
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import devices as ref_devices  # noqa: E402
from seaweedfs_tpu_torch import tracing  # noqa: E402
from seaweedfs_tpu_torch.ops import link, profiler  # noqa: E402
from seaweedfs_tpu_torch.ops.codec import RSCodec  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import devices  # noqa: E402

# the port's backend -> the reference's backend of the same kind
BACKENDS = {"cuda": "pallas", "native": "native", "cpu": "numpy"}
RECORDS = [  # (port backend, o, k, input bytes, seconds)
    ("cuda", 4, 10, 10 << 20, 0.00113),
    ("cuda", 4, 10, 10 << 20, 0.0009),
    ("native", 4, 10, 40960, 0.00021),
    ("cuda", 1, 10, 10 << 20, 0.0042),
    ("cpu", 4, 10, 4096, 0.0003),
    ("native", 4, 10, 10 << 20, 0.0051),
    ("cuda", 4, 10, 0, 0.0001),
    ("cuda", 4, 10, 1 << 20, 0.0),  # no time: not device work
]
PROBE = {"h2d_gbps": 24.0, "d2h_gbps": 21.5, "rtt_s": 4e-5,
         "probe_bytes": float(1 << 20)}


@pytest.fixture
def fresh(monkeypatch):
    """Fresh dispatch families, ledgers and probed link states on both
    sides, each family in its own package's class."""
    for pkg, prof, dev_mod, lnk, mod in (
            (metrics, profiler, devices, link, link),
            (ref_metrics, ref_profiler, ref_devices, ref_link, ref_link)):
        monkeypatch.setattr(prof, "DISPATCH_SECONDS", pkg.Histogram(
            "seaweedfs_codec_dispatch_seconds",
            "GF codec dispatch wall seconds (incl. sync) by backend",
            ("backend", "shape")))
        monkeypatch.setattr(prof, "DISPATCH_BYTES", pkg.Counter(
            "seaweedfs_codec_dispatch_bytes_total",
            "Input bytes fed through the GF codec by backend",
            ("backend", "shape")))
        monkeypatch.setattr(dev_mod, "LEDGER", dev_mod.DeviceLedger())
        state = lnk.LinkState()
        state.probe_result = dict(PROBE)
        monkeypatch.setattr(mod, "STATE", state)
        monkeypatch.setattr(prof, "_records", type(prof._records)(
            maxlen=prof._MAX_RECORDS))


def feed(records, mapped):
    for backend, o, k, n, s in records:
        profiler.record(backend, o, k, n, s)
        ref_profiler.record(BACKENDS[backend] if mapped else backend,
                            o, k, n, s)


def test_dispatch_exposition_matches_reference(fresh):
    feed(RECORDS, mapped=False)  # the same label values on both sides
    for name in ("DISPATCH_SECONDS", "DISPATCH_BYTES"):
        assert getattr(profiler, name).expose() == \
            getattr(ref_profiler, name).expose()


def test_records_ring_matches_reference(fresh):
    feed(RECORDS[:2], mapped=False)  # collection off: nothing kept
    assert profiler.records() == [] == ref_profiler.records()
    with profiler.enabled(), ref_profiler.enabled():
        assert profiler.is_enabled() and ref_profiler.is_enabled()
        feed(RECORDS, mapped=False)
    assert not profiler.is_enabled()
    got = [(r.backend, r.shape, r.in_bytes, r.seconds, r.gbps, str(r))
           for r in profiler.records()]
    want = [(r.backend, r.shape, r.in_bytes, r.seconds, r.gbps, str(r))
            for r in ref_profiler.records()]
    assert got == want and len(got) == len(RECORDS)
    profiler.clear()
    assert profiler.records() == []


def test_ledger_matches_reference_under_the_backend_map(fresh):
    base = devices.LEDGER.baseline()
    ref_base = ref_devices.LEDGER.baseline()
    feed(RECORDS, mapped=True)
    for lane, secs, n in ((0, 0.01, 100), (1, 0.02, 200), (0, 0.0, 5),
                          (15, 0.5, 1), (16, 0.25, 2), (99, 0.125, 3),
                          ("x", 0.1, 4)):
        devices.LEDGER.record_lane(lane, secs, n)
        ref_devices.LEDGER.record_lane(lane, secs, n)
    devices.LEDGER.record_stage(0.003)
    ref_devices.LEDGER.record_stage(0.003)
    snap = devices.LEDGER.snapshot()
    assert snap == ref_devices.LEDGER.snapshot()
    assert devices.LEDGER.snapshot(base) == \
        ref_devices.LEDGER.snapshot(ref_base)
    assert devices.LEDGER.summary() == ref_devices.LEDGER.summary()
    # only the card's dispatches with time count, on row "0"
    row, = snap["devices"]
    cuda = [r for r in RECORDS if r[0] == "cuda" and r[4] > 0]
    assert row["device"] == "0" and row["dispatches"] == len(cuda)
    assert row["h2d_bytes"] == sum(r[3] for r in cuda)
    # lanes past the cap share one label
    assert [lr["lane"] for lr in snap["lanes"]] == ["0", "1", "15", "16+",
                                                   "x"]
    assert devices.LEDGER.busy_seconds("0") == \
        ref_devices.LEDGER.busy_seconds("0")
    assert devices.LEDGER.lane_busy_seconds() == \
        ref_devices.LEDGER.lane_busy_seconds()
    assert devices.LEDGER.imbalance_frac() == \
        ref_devices.LEDGER.imbalance_frac()
    devices.LEDGER.reset()
    ref_devices.LEDGER.reset()
    assert devices.LEDGER.summary() is None is ref_devices.LEDGER.summary()
    assert devices.LEDGER.snapshot() == ref_devices.LEDGER.snapshot()


def test_host_backends_never_reach_the_ledger(fresh):
    for backend in ("native", "cpu"):
        profiler.record(backend, 4, 10, 1 << 20, 0.01)
    assert devices.LEDGER.snapshot()["devices"] == []
    profiler.record("cuda", 4, 10, 1 << 20, 0.01)
    assert devices.LEDGER.snapshot()["devices"][0]["dispatches"] == 1


def test_dispatch_spans_match_reference(fresh, monkeypatch):
    monkeypatch.setattr(tracing.recorder, "RECORDER",
                        tracing.SpanRecorder())
    monkeypatch.setattr(ref_tracing.recorder, "RECORDER",
                        ref_tracing.SpanRecorder())
    got = []
    for pkg, prof in ((tracing, profiler), (ref_tracing, ref_profiler)):
        with pkg.start_span("ec", "encode") as root:
            for backend, o, k, n, s in RECORDS[:3]:
                prof.record(backend, o, k, n, s)
        prof.record("cuda", 4, 10, 1, 1.0)  # no parent: no span
        with prof.timed("native", 4, 10, 100):
            pass
        spans = pkg.recorder.RECORDER.spans()
        # the root's duration is its own wall time
        got.append([(s.component, s.op, s.attrs,
                     s.parent_id == root.span_id,
                     s.duration if s is not root else None)
                    for s in spans])
    assert got[0] == got[1]
    assert len(got[0]) == 4  # three dispatches and the root


def test_timed_matches_reference(fresh, monkeypatch):
    """``timed`` records the scope's time under the same clock, also
    when its body raises: the same families, ledger and spans under the
    backend map."""
    import time

    now = [50.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    monkeypatch.setattr(tracing.recorder, "RECORDER",
                        tracing.SpanRecorder())
    monkeypatch.setattr(ref_tracing.recorder, "RECORDER",
                        ref_tracing.SpanRecorder())
    got = []
    for pkg, prof, names in ((tracing, profiler, {}),
                             (ref_tracing, ref_profiler, BACKENDS)):
        now[0] = 50.0  # the same clock readings on both sides
        with pkg.start_span("ec", "encode") as root:
            for backend, o, k, n, s in RECORDS:
                with prof.timed(names.get(backend, backend), o, k, n):
                    now[0] += s
            with pytest.raises(ValueError):
                with prof.timed("native", 4, 10, 64):
                    now[0] += 0.002
                    raise ValueError("dispatch failed")
        spans = [(s.op, s.duration, s.attrs, s.parent_id == root.span_id)
                 for s in pkg.recorder.RECORDER.spans() if s is not root]
        got.append((spans, prof.DISPATCH_BYTES.values(),
                    prof.DISPATCH_SECONDS.snapshot()))
    (spans, counts, hist), (ref_spans, ref_counts, ref_hist) = got
    for old, new in BACKENDS.items():
        spans = [(op.replace(f"({old},", f"({new},"), *rest)
                 for op, *rest in spans]
    assert spans == ref_spans and len(spans) == len(RECORDS) + 1
    assert {(BACKENDS[b], sh): v for (b, sh), v in counts.items()} == \
        ref_counts
    assert {(BACKENDS[b], sh): v for (b, sh), v in hist.items()} == \
        ref_hist
    assert devices.LEDGER.snapshot() == ref_devices.LEDGER.snapshot()


def test_annotation_names_the_codec_dispatch_in_a_torch_profile(fresh):
    rs = RSCodec(10, 4, device="cpu")
    data = np.ones((10, 512), np.uint8)
    profiler.annotate(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                rs.encode(data)
    finally:
        profiler.annotate(False)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("codec.encode(cpu,4x10)") == 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rs.encode(data)
    assert "codec.encode(cpu,4x10)" not in {
        e.key for e in prof.key_averages()}


def test_recording_cost_leaves_the_records_as_they_were():
    """chip_smoke measures recording's cost on scratch copies: what it
    records lands there, and every family, the link state, the ledger
    and the span ring are the process's own again afterwards, and
    unchanged."""
    import chip_smoke
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.tracing import recorder

    def state():
        return (metrics.REGISTRY.expose(), link.STATE, link.snapshot(),
                devices.LEDGER, devices.LEDGER.snapshot(),
                recorder.RECORDER, len(recorder.RECORDER.spans()))

    before = state()
    with chip_smoke.scratch_recording():
        assert link.STATE is not before[1]
        assert devices.LEDGER is not before[3]
        with tracing.start_span("chip_smoke", "scratch") as root:
            for _ in range(3):
                codec_mod._record("cuda", "link", 4, 10, 10 << 20, 1e-3,
                                  root)
        assert link.ROUTE_TOTAL.values() == {("device", "link"): 3.0}
        assert devices.LEDGER.snapshot()["devices"][0]["dispatches"] == 3
        assert len(recorder.RECORDER.spans()) == 4
    assert state() == before
    assert chip_smoke.recording_cost(5, 1 << 20) > 0
    assert state() == before
