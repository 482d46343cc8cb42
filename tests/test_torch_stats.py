"""The port's metrics registry against the reference's: the same
operations on a fresh ``Registry`` of each package give identical
Prometheus exposition text."""

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu_torch import stats  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics  # noqa: E402


def counters(reg):
    c = reg.counter("seaweedfs_codec_route_total", "routes",
                    ("path", "reason"))
    c.inc("device", "link")
    c.inc("device", "link")
    c.inc("host", "size", amount=3)
    c.inc("host", "error", amount=0.5)
    reg.counter("seaweedfs_plain_total", "no labels").inc()


def gauges(reg):
    g = reg.gauge("seaweedfs_codec_link_gbps", "EWMA", ("path",))
    g.set(12.5, "device")
    g.set(0.5, "host")
    g.set(13.25, "device")  # the last value wins
    reg.gauge("seaweedfs_empty", "never set", ("path",))


def histograms(reg):
    h = reg.histogram("seaweedfs_codec_dispatch_seconds", "dispatch",
                      ("backend", "shape"))
    for v in (0.00005, 0.0001, 0.00011, 0.003, 0.5, 2.0, 1e4):
        h.observe(v, "cuda", "4x10")
    h.observe(0.02, "native", "4x10")
    small = reg.histogram("seaweedfs_phase_seconds", "phases",
                          ("op", "phase"), start=0.001, factor=10.0,
                          count=4)
    for v in (0.0005, 0.001, 0.05, 7.0, 70.0):
        small.observe(v, "ec.encode", "read")


def escaping(reg):
    c = reg.counter("seaweedfs_escape_total", "label escaping",
                    ("value",))
    for v in ('a"b', "back\\slash", "new\nline", 'all\\"\n'):
        c.inc(v)
    reg.gauge("seaweedfs_escape_gauge", "", ("v",)).set(1.0, 'q"')


def merged(reg):
    h = reg.histogram("seaweedfs_lock_wait_seconds", "merged",
                      ("site",), count=6)
    h.observe(0.00015, "a")
    h.merge_counts([1, 0, 2, 0, 0, 0, 9], 3, 0.0042, "a")
    h.merge_counts([0, 4], 4, 0.001, "b")


SCENARIOS = {"counters": counters, "gauges": gauges,
             "histograms": histograms, "escaping": escaping,
             "merge_counts": merged}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_exposition_matches_reference(name):
    port, ref = metrics.Registry(), ref_metrics.Registry()
    SCENARIOS[name](port)
    SCENARIOS[name](ref)
    assert port.expose() == ref.expose()


def test_all_scenarios_in_one_registry():
    port, ref = metrics.Registry(), ref_metrics.Registry()
    for fill in SCENARIOS.values():
        fill(port)
        fill(ref)
    text = port.expose()
    assert text == ref.expose()
    assert '{value="a\\"b"}' in text and '{value="new\\nline"}' in text


def test_snapshot_values_and_duplicates_match_reference():
    port, ref = metrics.Registry(), ref_metrics.Registry()
    for reg in (port, ref):
        histograms(reg)
        counters(reg)
    p_fam = {f.name: f for f in port.families()}
    r_fam = {f.name: f for f in ref.families()}
    assert list(p_fam) == list(r_fam)
    h = "seaweedfs_codec_dispatch_seconds"
    assert p_fam[h].snapshot() == r_fam[h].snapshot()
    c = "seaweedfs_codec_route_total"
    assert p_fam[c].values() == r_fam[c].values()
    for reg in (port, ref):
        with pytest.raises(ValueError):
            reg.counter(c)


def test_port_registry_is_its_own():
    """The port's families live in its REGISTRY, not the reference's."""
    assert stats.REGISTRY is metrics.REGISTRY
    assert stats.REGISTRY is not ref_metrics.REGISTRY
    # importing the modules registers their families
    import seaweedfs_tpu_torch.ops.codec  # noqa: F401
    import seaweedfs_tpu_torch.telemetry.phases  # noqa: F401

    names = {f.name for f in stats.REGISTRY.families()}
    assert {"seaweedfs_codec_route_total", "seaweedfs_codec_link_gbps",
            "seaweedfs_codec_dispatch_seconds",
            "seaweedfs_codec_dispatch_bytes_total",
            "seaweedfs_device_busy_seconds", "seaweedfs_phase_seconds",
            "seaweedfs_trace_span_seconds",
            "seaweedfs_fault_injected_total"} <= names
    text = stats.REGISTRY.expose()
    assert "# TYPE seaweedfs_codec_route_total counter" in text
