"""One package's request sequence, alone in a fresh process.

``python tests/_torch_middleware_child.py {ref|port} {master|volume} DIR``
starts one server of that package, sends it the sequence of
``tests/test_torch_middleware.py`` and prints the answers as one JSON
line. Run in its own interpreter, the server's request counts come from
its own span histogram only: no other server of the package can add to
them.
"""

import http.client
import importlib
import json
import os
import sys
import urllib.parse

NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
PACKAGES = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
DEBUG = ("/debug/vars", "/debug/slow", "/debug/traces?limit=3",
         "/debug/timeline?seconds=5", "/debug/contention?top=3",
         "/debug/devices")
BENCH = {"metric": "load_ops_per_second", "value": 321.5,
         "unit": "ops/s",
         "detail": {"phases": {"write": {"p99_ms": 8.5, "failures": 2},
                               "read": {"p99_ms": 12.25, "failures": 0}},
                    "protocols": {"native": {"ops_s": 300.0,
                                             "p99_s": 0.01,
                                             "error_rate": 0.001}}}}


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


def master_sequence(pkg):
    M = importlib.import_module(f"{pkg}.server.master").MasterServer
    rec = importlib.import_module(f"{pkg}.tracing.recorder")
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
        # (``contention`` is left out: it reads the package's own
        # process-wide lock witness, which no child installs)
        seq.append((own["requests"]["total"], own["requests"]["errors"],
                    own["benchmark"]))
        seq.append(sorted(_op_counts(rec.SPAN_SECONDS, "master").items()))
        return seq
    finally:
        m.stop()


def volume_sequence(pkg, root):
    V = importlib.import_module(f"{pkg}.server.volume").VolumeServer
    rec = importlib.import_module(f"{pkg}.tracing.recorder")
    kw = {"device": "cpu"} if pkg == PACKAGES["port"] else {}
    vs = V(NO_MASTER, [root], pulse_seconds=60, **kw)
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
        seq.append(sorted(_op_counts(rec.SPAN_SECONDS, "volume").items()))
        return seq
    finally:
        vs.stop()


def main(argv):
    which, kind, root = argv
    pkg = PACKAGES[which]
    if which == "port":
        import torch

        torch.set_num_threads(2)
    os.makedirs(root, exist_ok=True)
    seq = (master_sequence(pkg) if kind == "master"
           else volume_sequence(pkg, root))
    print(json.dumps(seq))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
