"""Each port server's telemetry counts the requests it answered.

The span histogram and the error counter of both packages are keyed by
(component, op) and (component, class), so every volume server of one
process reported the same counts: one server's 5xx marked every volume
server of an in-process fleet ``error-rate``, and one slow request put
every window p99 over the objective. The port's servers each keep a
``RequestTally`` beside those families (``tracing/middleware.py``)
and their snapshots read it.

Here two in-process volume servers share a replicated volume; the port's
fault points make one answer 5xx (a refused replica write fails the
quorum) until its own interval shows them, and one slow request (a
stalled replica write). The other server must carry no mark of its own,
and the cluster rollup must count each 5xx once. With one live volume
server in the process, its snapshot counts what the reference's counts
on the same traffic, and equals, field for field, what the reference's
rule (the process's families by component) reads from the same spans.
Untimed requests (streams, bulk jobs) count in a server's requests and
errors but not in its latency, and every server listens with the
kernel's backlog.
"""

import socket
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolumeServer,
)
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import snapshot as ref_snap  # noqa: E402
from seaweedfs_tpu.tracing import recorder as ref_recorder  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import fault, tracing  # noqa: E402
from seaweedfs_tpu_torch.operation import client as port_client  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.server.volume import (  # noqa: E402
    VolumeServer as PortVolumeServer,
)
from seaweedfs_tpu_torch.stats import metrics as port_metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import snapshot as port_snap  # noqa: E402
from seaweedfs_tpu_torch.tracing import middleware as trace_mw  # noqa: E402
from seaweedfs_tpu_torch.tracing import recorder as port_recorder  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util.http import (  # noqa: E402
    HttpServer,
    Request,
    Response,
    Router,
)
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SEED = 24
NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail


@pytest.fixture
def clean():
    fault.REGISTRY.clear()
    yield
    fault.REGISTRY.clear()
    port_retry.BREAKERS.reset()
    ref_retry.BREAKERS.reset()
    port_client._lookup_cache.clear()


def _fresh_families(monkeypatch, snap, rec, metrics):
    """A fresh span histogram and error counter in place of the ones a
    package's recorder feeds and its collector reads."""
    reg = metrics.Registry()
    hist = reg.histogram(rec.SPAN_SECONDS.name, "t", ("component", "op"))
    errs = reg.counter(rec.SPAN_ERRORS.name, "t", ("component", "class"))
    for mod in (snap, rec):
        monkeypatch.setattr(mod, "SPAN_SECONDS", hist)
        monkeypatch.setattr(mod, "SPAN_ERRORS", errs)


def _view(master_url, until, timeout=20.0):
    """The master's view once ``until(rows)`` holds, rows by url."""
    deadline = time.time() + timeout
    while True:
        view = http.get_json(f"{master_url}/cluster/telemetry")
        rows = {s["url"]: s for s in view["servers"]
                if s.get("component") == "volume"}
        if until(rows):
            return rows, view
        assert time.time() < deadline, rows
        time.sleep(0.1)


def test_each_server_judged_on_its_own_requests(tmp_path, clean):
    rng = np.random.default_rng(SEED)
    with ClusterHarness(n_volume_servers=2, device="cpu",
                        root=str(tmp_path)) as c:
        m = c.master.url
        # one volume, a copy on each server (the two sit on two racks)
        grown = http.get_json(f"{m}/vol/grow?count=1&replication=010")
        assert grown["count"] >= 1 and "error" not in grown
        first = port_client.assign(m, replication="010")
        a = next(vs for vs in c.volume_servers if vs.url == first.url)
        b = next(vs for vs in c.volume_servers if vs is not a)
        # the fault specs match their peer by substring
        assert b.url not in a.url
        vid = first.fid.split(",")[0]
        fids = iter(f"{vid},{i:x}0000{i:04x}" for i in range(1, 100))

        # a: writes whose replica to b is refused (quorum not met, 500)
        # until a's own interval shows them (an idle interval reads no
        # error rate), then one whose replica stalls 2.5 s (over the 2 s
        # p99, held for the window)
        failed = 0
        deadline = time.time() + 20.0
        while True:
            fault.REGISTRY.inject("volume.replicate.send", kind="error",
                                  peer=b.url, count=1)
            with pytest.raises(http.HttpError) as e:
                http.request("POST", f"{a.url}/{next(fids)}",
                             rng.bytes(1000))
            assert e.value.status == 500
            failed += 1
            view = http.get_json(f"{m}/cluster/telemetry")
            rows = {s["url"]: s for s in view["servers"]
                    if s.get("component") == "volume"}
            if "error-rate" in rows.get(a.url, {}).get("degraded", ()):
                break
            assert time.time() < deadline, rows
            time.sleep(0.05)
        assert 0 < rows[a.url]["requests"]["errors"] <= failed
        assert rows[b.url]["requests"]["errors"] == 0
        assert "error-rate" not in rows[b.url]["degraded"]
        fault.REGISTRY.inject("volume.replicate.send", kind="latency",
                              peer=b.url, delay=2.5, count=1)
        t0 = time.perf_counter()
        http.request("POST", f"{a.url}/{next(fids)}", rng.bytes(1000))
        assert time.perf_counter() - t0 >= 2.5
        rows, _ = _view(m, lambda r: "p99"
                        in r.get(a.url, {}).get("degraded", ()))
        assert rows[a.url]["requests"]["errors"] == failed
        assert rows[b.url]["requests"]["errors"] == 0
        assert "error-rate" not in rows[b.url]["degraded"]
        assert "p99" not in rows[b.url]["degraded"]

        # b: twenty fast writes (each replicated to a) and reads
        for _ in range(20):
            fid = next(fids)
            body = rng.bytes(1000)
            http.request("POST", f"{b.url}/{fid}", body)
            assert http.request("GET", f"{b.url}/{fid}") == body
        rows, view = _view(m, lambda r: r.get(b.url, {}).get(
            "requests", {}).get("total", 0) >= 40)
        rb = rows[b.url]
        assert rb["requests"]["errors"] == 0
        assert rb["requests"]["p99_seconds"] < 2.0
        assert "error-rate" not in rb["degraded"]
        assert "p99" not in rb["degraded"]
        # the rollup counts each 5xx once
        assert view["requests"]["errors"] == failed


def _traffic(url, seed):
    """The same requests to one volume server: writes, reads, a 404."""
    rng = np.random.default_rng(seed)
    http.post_json(f"{url}/admin/assign_volume", {"volume": 3})
    for i in range(1, 25):
        body = rng.bytes(int(rng.integers(100, 5000)))
        http.request("POST", f"{url}/3,{i:x}0000{i:04x}", body)
        assert http.request("GET", f"{url}/3,{i:x}0000{i:04x}") == body
    for i in (90, 91):
        with pytest.raises(http.HttpError) as e:
            http.request("GET", f"{url}/3,{i:x}0000{i:04x}")
        assert e.value.status == 404


# the fields that hold no time: equal across the two packages
COUNTS = ("total", "errors", "errors_4xx", "delta", "error_delta",
          "error_rate", "window_seconds", "window_total")


def test_one_server_snapshot_matches_reference(tmp_path, monkeypatch,
                                               clean):
    # a volume server that served and stopped earlier in the process
    # (another test's, in a shared worker) must not count
    old = PortVolumeServer(NO_MASTER, [str(tmp_path / "old")],
                           pulse_seconds=60, device="cpu")
    old.start()
    try:
        _traffic(old.url, SEED + 1)
    finally:
        old.stop()

    _fresh_families(monkeypatch, ref_snap, ref_recorder, ref_metrics)
    ref = RefVolumeServer(NO_MASTER, [str(tmp_path / "ref")],
                          pulse_seconds=60)
    ref.start()  # its first heartbeat collects the baseline
    try:
        _traffic(ref.url, SEED)
        want = ref._telemetry.collect()["requests"]
    finally:
        ref.stop()
    port = PortVolumeServer(NO_MASTER, [str(tmp_path / "port")],
                            pulse_seconds=60, device="cpu")
    port.start()
    try:
        _traffic(port.url, SEED)
        got = port._telemetry.collect()["requests"]
    finally:
        port.stop()
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["total"] == 24 * 2 + 2 + 1 and got["errors_4xx"] == 2

    # field for field, the reference's rule on the same spans: families
    # only this server feeds, read by component
    _fresh_families(monkeypatch, port_snap, port_recorder, port_metrics)
    port = PortVolumeServer(NO_MASTER, [str(tmp_path / "port2")],
                            pulse_seconds=60, device="cpu")
    port.start()
    try:
        by_component = port_snap.TelemetryCollector("volume")
        by_component.collect()
        _traffic(port.url, SEED)
        got = port._telemetry.collect()["requests"]
        rule = by_component.collect()["requests"]
    finally:
        port.stop()
    mean = got.pop("mean_seconds")
    assert mean == pytest.approx(rule.pop("mean_seconds"), abs=2e-6)
    assert got == rule


def test_long_running_spans_stay_out_of_the_tally(monkeypatch):
    """A request to an untimed route (``middleware.UNTIMED``: a stream
    open for its connection's life, a bulk job) counts in its server's
    requests and errors, a failed shard copy's 5xx too, and stays out
    of the server's latency; every other answer counts in both, and the
    process's span families count every request."""
    _fresh_families(monkeypatch, port_snap, port_recorder, port_metrics)
    router = Router()
    router.add("POST", r"/admin/ec/rebuild",
               lambda req: Response.json({"rebuilt_shards": []}))
    router.add("POST", r"/admin/ec/copy",
               lambda req: Response.error("copy .ec00: refused", 500))
    router.add("GET", r"/answer", lambda req: Response.json({"ok": True}))
    router.add("GET", r"/fails", lambda req: Response.error("x", 503))
    traced = trace_mw.instrument(router, "volume")
    col = port_snap.TelemetryCollector("volume", tally=traced.tally)
    col.collect()  # the baseline
    for method, path in (("POST", "/admin/ec/rebuild"), ("GET", "/answer"),
                         ("GET", "/fails"), ("POST", "/admin/ec/copy")):
        traced.dispatch(Request(method, path, {}, {}))
    counts, timed, _sum = port_snap.merge_histogram(traced.tally.seconds)
    assert timed == 2 and sum(counts) == 2
    assert traced.tally.counts() == (4, {"4xx": 0, "5xx": 2})
    _c, everything, _s = port_snap.merge_histogram(
        port_recorder.SPAN_SECONDS, "volume")
    assert everything == 4
    req = col.collect()["requests"]
    assert (req["total"], req["errors"], req["delta"], req["error_delta"],
            req["error_rate"], req["window_total"]) == (4, 2, 4, 2, 0.5, 2)


def test_listen_backlog_holds_a_burst_of_connects():
    """A server whose accepting thread is held off (here: never started)
    still completes every connect of a burst: the backlog is the
    kernel's limit, not the standard library's 5, past which each SYN
    is dropped and the client waits out its retransmits."""
    srv = HttpServer(Router())  # bound and listening, nothing accepts
    socks = []
    try:
        for _ in range(32):
            s = socket.socket()
            s.settimeout(2.0)
            s.connect(("127.0.0.1", srv.port))
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        srv._httpd.server_close()
    assert len(socks) == 32
