"""The port's request-tracing middleware (``tracing/middleware.py``), its
``/debug/*`` plane (``telemetry/{debug,profile}.py``) and the master's
``/cluster/benchmark`` held against the reference's on the CPU.

One request sequence goes to a master of each package and one to a
volume server of each package (``device="cpu"``, no master listening):
the same statuses, the same ``/debug/*`` keys, the same trace ids
echoed, and the same request counts — in the master's own row of
``/cluster/telemetry`` and per op in each package's span histogram,
which the middleware now feeds. Each package gets a fresh span
histogram and error counter, so counts start at zero.
"""

import http.client
import json
import urllib.parse

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.server.master import (  # noqa: E402
    MasterServer as RefMaster,
)
from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolume,
)
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import snapshot as ref_snap  # noqa: E402
from seaweedfs_tpu.tracing import recorder as ref_rec  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch.server.master import (  # noqa: E402
    MasterServer as PortMaster,
)
from seaweedfs_tpu_torch.server.volume import (  # noqa: E402
    VolumeServer as PortVolume,
)
from seaweedfs_tpu_torch.stats import metrics as port_metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import snapshot as port_snap  # noqa: E402,E501
from seaweedfs_tpu_torch.tracing import recorder as port_rec  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
PKGS = {
    "ref": (RefMaster, RefVolume, ref_snap, ref_rec, ref_metrics,
            ref_retry),
    "port": (PortMaster, PortVolume, port_snap, port_rec, port_metrics,
             port_retry),
}
DEBUG = ("/debug/vars", "/debug/slow", "/debug/traces?limit=3",
         "/debug/timeline?seconds=5", "/debug/contention?top=3",
         "/debug/devices")


@pytest.fixture
def spans(monkeypatch, tmp_path):
    """A fresh span histogram and error counter per package, and no
    load-round file for either master to read."""
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    fams = {}
    for name, (_m, _v, snap, rec, metrics, retry) in PKGS.items():
        reg = metrics.Registry()
        hist = reg.histogram(rec.SPAN_SECONDS.name, "t",
                             ("component", "op"))
        errs = reg.counter(rec.SPAN_ERRORS.name, "t",
                           ("component", "class"))
        for mod in (snap, rec):
            monkeypatch.setattr(mod, "SPAN_SECONDS", hist)
            monkeypatch.setattr(mod, "SPAN_ERRORS", errs)
        retry.BREAKERS.reset()
        fams[name] = hist
    yield fams


def call(url, method, path, body=None, headers=None):
    """(status, headers, body) of one request, no retries."""
    u = urllib.parse.urlsplit(url if "//" in url else f"http://{url}")
    conn = http.client.HTTPConnection(u.netloc, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _op_counts(hist, component):
    return {labels[1]: v[1] for labels, v in hist.snapshot().items()
            if labels[0] == component}


def _keys(body: bytes):
    doc = json.loads(body)
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


BENCH = {"metric": "load_ops_per_second", "value": 321.5,
         "unit": "ops/s",
         "detail": {"phases": {"write": {"p99_ms": 8.5, "failures": 2},
                               "read": {"p99_ms": 12.25, "failures": 0}},
                    "protocols": {"native": {"ops_s": 300.0,
                                             "p99_s": 0.01,
                                             "error_rate": 0.001}}}}


def _master_sequence(M, hist):
    m = M(pulse_seconds=0.2)
    m.start()
    try:
        u = m.url
        seq = []
        for method, path, body in (
                ("GET", "/cluster/status", None),
                ("GET", "/dir/lookup?volumeId=9", None),
                ("GET", "/cluster/benchmark", None),
                ("POST", "/cluster/benchmark", json.dumps(BENCH).encode()),
                ("GET", "/cluster/benchmark", None),
                ("POST", "/cluster/benchmark", b'{"detail": "no value"}'),
                ("POST", "/cluster/benchmark", b'[1, 2]'),
                ("GET", "/no/such/route", None)):
            status, _h, data = call(u, method, path, body)
            doc = json.loads(data) if path == "/cluster/benchmark" else None
            if isinstance(doc, dict) and doc.get("benchmark"):
                doc["benchmark"].pop("received_at")
            seq.append((method, path, status, doc))
        for path in DEBUG:
            status, headers, data = call(u, "GET", path)
            seq.append(("GET", path, status, _keys(data),
                        headers.get("Content-Type")))
        for path in ("/debug/stacks", "/debug/profile?seconds=0.2&hz=50"):
            status, headers, data = call(u, "GET", path)
            seq.append(("GET", path, status,
                        headers.get("Content-Type"), bool(data)))
        # an inbound traceparent: the response echoes its trace id and
        # the span lands in the ring under it, a child of the caller
        status, headers, _ = call(u, "GET", "/cluster/status", headers={
            "traceparent": f"00-{TRACE}-{PARENT}-01"})
        traced = json.loads(call(u, "GET",
                                 f"/debug/traces?traceId={TRACE}")[2])
        seq.append((status, headers.get("X-Trace-Id"),
                    [(s["trace_id"], s["parent_id"], s["component"],
                      s["status"]) for s in traced["spans"]]))
        view = json.loads(call(u, "GET", "/cluster/telemetry")[2])
        [own] = [s for s in view["servers"] if s["component"] == "master"]
        own["benchmark"].pop("received_at")
        # (``contention`` is left out: it reads each package's own
        # process-wide witness, which only the reference's suite installs)
        seq.append((own["requests"]["total"], own["requests"]["errors"],
                    own["benchmark"]))
        seq.append(sorted(_op_counts(hist, "master").items()))
        return seq
    finally:
        m.stop()


def test_master_sequence_matches_reference(spans):
    got = {name: _master_sequence(PKGS[name][0], spans[name])
           for name in PKGS}
    assert got["port"] == got["ref"]
    seq = got["port"]
    # what the sequence says, beyond agreeing
    assert [s[2] for s in seq[2:7]] == [200, 200, 200, 400, 400]
    assert seq[2][3] == {"benchmark": None}
    assert seq[4][3]["benchmark"]["ops_per_second"] == 321.5
    assert seq[4][3]["benchmark"]["p99_ms"] == 12.25
    assert seq[4][3]["benchmark"]["failures"] == 2
    assert seq[4][3]["benchmark"]["source"] == "push"
    assert seq[-3] == (200, TRACE, [(TRACE, PARENT, "master", 200)])
    total, _errors, bench = seq[-2]
    # every request before the telemetry read was counted
    assert total == 8 + len(DEBUG) + 2 + 2
    assert bench["protocols"]["native"]["ops_s"] == 300.0


def _volume_sequence(V, hist, root):
    kw = {"device": "cpu"} if V is PortVolume else {}
    vs = V(NO_MASTER, [str(root)], pulse_seconds=60, **kw)
    vs.start()
    try:
        u = vs.url
        seq = []
        for method, path, body in (
                ("POST", "/admin/assign_volume", b'{"volume": 3}'),
                ("POST", "/3,01637037d6?ts=1700000000", b"hello world"),
                ("GET", "/3,01637037d6", None),
                ("GET", "/3,02637037d6", None),
                ("DELETE", "/3,01637037d6", None),
                ("GET", "/3,01637037d6", None),
                ("GET", "/status", None),
                ("GET", "/admin/tail?volume=3", None)):
            status, headers, _data = call(u, method, path, body)
            seq.append((method, path, status, len(headers["X-Trace-Id"])))
        for path in DEBUG:
            status, headers, data = call(u, "GET", path)
            seq.append(("GET", path, status, _keys(data)))
        seq.append(sorted(_op_counts(hist, "volume").items()))
        return seq
    finally:
        vs.stop()


def test_volume_sequence_matches_reference(spans, tmp_path):
    got = {name: _volume_sequence(PKGS[name][1], spans[name],
                                  tmp_path / name)
           for name in PKGS}
    # the port answers /admin/tail with a 501 until volume_backup lands
    for name in got:
        tail = got[name][7]
        assert tail[1] == "/admin/tail?volume=3"
        got[name][7] = tail[:2]
    assert got["port"] == got["ref"]
    seq = got["port"]
    assert [s[2] for s in seq[:7]] == [200, 200, 200, 404, 200, 404, 200]
    counts = dict(seq[-1])
    assert sum(counts.values()) == 8 + len(DEBUG)
