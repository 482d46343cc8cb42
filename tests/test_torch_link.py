"""The port's link-aware routing against the reference's: the same
observations give the same ``choose`` decisions and reasons, the same
estimates, and the same ``choose_pipeline`` sizing.

Both sides run on fresh ``LinkState`` objects. ``load`` (a helper of
this file, not package API) carries one state's EWMAs and probe result
into another, so both packages are asked with the same estimates."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import link as ref_link  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
)
from seaweedfs_tpu_torch.ops import link  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import encoder  # noqa: E402

PROBE = {"h2d_gbps": 24.0, "d2h_gbps": 21.5, "rtt_s": 4e-5,
         "probe_bytes": float(1 << 20)}
MIB = 1 << 20


def load(dst, src=None, gbps=None, probe=None):
    """Carry ``src``'s EWMAs and probe result (or the given ones) into
    the state ``dst``."""
    if src is not None:
        gbps, probe = dict(src._gbps), src.probe_result
        dst._since_device = src._since_device
    dst._gbps = dict(gbps or {})
    dst.probe_result = None if probe is None else dict(probe)


@pytest.fixture
def states(monkeypatch):
    """Fresh, probed states installed as each package's ``STATE``."""
    port, ref = link.LinkState(), ref_link.LinkState()
    for st in (port, ref):
        load(st, probe=PROBE)
    monkeypatch.setattr(link, "STATE", port)
    monkeypatch.setattr(ref_link, "STATE", ref)
    monkeypatch.setattr(ref_link, "_enabled", True)
    return port, ref


def script(n=200):
    """200 steps: a healthy card, a link that degrades to a crawl (the
    host wins; every 32nd dispatch re-probes the card), then recovers;
    sizes from 256 KiB to 80 MiB."""
    rng = np.random.default_rng(3)
    sizes = (256 << 10, MIB, 10 * MIB, 80 * MIB)
    for i in range(n):
        size = sizes[int(rng.integers(len(sizes)))]
        if i < 60:
            dev_gbps = 30.0 + rng.random()
        elif i < 150:
            dev_gbps = 0.02 * (1 + rng.random())  # degraded
        else:
            dev_gbps = 25.0 * (1 + rng.random())  # recovered
        host_gbps = 2.0 + rng.random()
        yield size, dev_gbps, host_gbps, i % 5 == 0


def run_script(st):
    decisions = []
    for size, dev_gbps, host_gbps, zero in script():
        use, reason = st.choose(size)
        decisions.append((use, reason))
        route = "device" if use else "host"
        gbps = dev_gbps if use else host_gbps
        st.observe(route, size, size / (gbps * 1e9))
        if zero:  # a zero-byte or zero-second sample changes nothing
            st.observe(route, 0, 1.0)
            st.observe(route, size, 0.0)
    return decisions


def test_scripted_trace_matches_reference(states):
    port, ref = states
    got, want = run_script(port), run_script(ref)
    assert got == want
    # no device estimate before the first observation: "default"
    assert got[0] == (True, "default")
    assert {r for _, r in got[1:]} == {"link", "probe"}
    assert sum(r == "probe" for _, r in got) >= 2
    assert not all(u for u, _ in got) and any(u for u, _ in got)
    assert port._gbps == ref._gbps
    assert link.estimates() == ref_link.estimates()
    assert link.snapshot() == ref_link.snapshot()


def test_default_reason_and_probe_seed_match_reference(states,
                                                       monkeypatch):
    port, ref = states
    for st in states:
        load(st, probe={})  # probed, nothing measured: no estimate
    assert port.choose(MIB) == ref.choose(MIB) == (True, "default")
    # a fresh state probes on its first decision and seeds the device
    # estimate from the probe as the reference does
    monkeypatch.setattr(link, "_measure_link", lambda device=None: PROBE)
    monkeypatch.setattr(ref_link, "_measure_link", lambda: PROBE)
    for st in states:
        load(st)
    assert port.choose(10 * MIB) == ref.choose(10 * MIB)
    assert port.probe_result == ref.probe_result == PROBE
    assert port.estimate("device") == ref.estimate("device")
    assert link.snapshot() == ref_link.snapshot()
    assert link.estimates() == ref_link.estimates()
    # a forced probe re-measures but keeps the observed estimate
    port.observe("device", 10 * MIB, 1e-3)
    ref.observe("device", 10 * MIB, 1e-3)
    assert link.probe(force=True) == ref_link.probe(force=True)
    assert port._gbps == ref._gbps


def test_failed_probe_raises_instead_of_routing_to_the_host(states,
                                                            monkeypatch):
    """The reference routes to the host ("noprobe") when its probe
    fails; the port raises."""
    port, ref = states

    def broken(*args, **kw):
        raise RuntimeError("no link")

    monkeypatch.setattr(link, "_measure_link", broken)
    monkeypatch.setattr(ref_link, "_measure_link", broken)
    for st in states:
        load(st)
    assert ref.choose(MIB) == (False, "noprobe")
    with pytest.raises(RuntimeError, match="no link"):
        port.choose(MIB)
    assert port.probe_result is None


def test_probe_wants_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        link.LinkState().probe("cpu")


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_probe_on_the_card():
    res = link.LinkState().probe(torch.device("cuda", 0))
    assert set(res) == {"h2d_gbps", "d2h_gbps", "rtt_s", "probe_bytes"}
    assert all(v > 0 for v in res.values())


EWMAS = {  # name -> (device GB/s, host GB/s) loaded before sizing
    "cold": (None, None),
    "device only": (40.0, None),
    "host only": (None, 3.0),
    "device far ahead": (40.0, 2.0),
    "device just ahead": (7.0, 2.0),
    "both slow": (0.004, 0.01),
    "mid": (1.7, 0.9),
}
SIZES = (MIB, 10 * MIB, 100 * MIB, 1 << 30, 10 << 30, 30 * 10**9)


@pytest.mark.parametrize("name", list(EWMAS))
def test_choose_pipeline_matches_reference(name, states):
    dev, host = EWMAS[name]
    gbps = {key: v for key, v in (("device", dev), ("host", host)) if v}
    for st in states:
        load(st, gbps=gbps, probe=PROBE)
    for size, volumes, devices, k in itertools.product(
            SIZES, (1, 4, 8), (1, 8), (10, 6)):
        got = encoder.choose_pipeline(size, k, volumes=volumes,
                                      devices=devices)
        want = ref_encoder.choose_pipeline(size, k, volumes=volumes,
                                           devices=devices)
        assert got == want, (size, volumes, devices, k)
    for pinned in (4096, 3 * MIB):
        assert encoder.choose_pipeline(size, batch_bytes=pinned) == \
            ref_encoder.choose_pipeline(size, batch_bytes=pinned)


def test_estimates_never_probe(monkeypatch):
    def broken(*args, **kw):
        raise AssertionError("estimates() probed")

    monkeypatch.setattr(link, "STATE", link.LinkState())
    monkeypatch.setattr(link, "_measure_link", broken)
    assert link.estimates() == {"device": None, "host": None,
                                "rtt_s": None}
    assert encoder.choose_pipeline(30 * 10**9) == (8 * MIB, 3)
