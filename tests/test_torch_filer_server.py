"""The port's filer server (``server/filer.py``) held against the
reference's on the CPU.

(a) One HTTP request sequence — auto-chunked writes at ``chunk_size=1024``,
    streamed, range and unsatisfiable reads, HEAD, listings with
    pagination, rename, hard links, recursive delete, ``?entry=true``,
    ``?meta=true``, KV, ``/__assign``, ``/meta/events``, a truncated
    upload and delete with chunk GC — against a port ``FilerServer`` over
    a port cluster (``device="cpu"``) and a reference one over a
    reference cluster: the same statuses, bodies and listed entries.
    Chunk fids (cookies are random) and wall-clock times are masked.
(b) Mixed clusters both ways: a port filer over the reference's master
    and volume servers, and the reverse; every file reads back
    byte-exact and a delete frees its chunks.
(c) A file whose volume is EC-encoded with four shards lost, read
    byte-exact through a port filer over port volume servers.
(d) The filer's metric families, and its KV routes under a signing key,
    as the reference's.
"""

import http.client
import json
import os
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.server.filer import (  # noqa: E402
    FilerServer as RefFilerServer,
)
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.filer import SqliteStore  # noqa: E402
from seaweedfs_tpu_torch.server.filer import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.shell import CommandEnv, run_command  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

RNG_SEED = 17


def _reset_clients():
    for op, retry in ((port_operation, port_retry),
                      (ref_operation, ref_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


def call(url, method, path, body=None, headers=None):
    """(status, selected headers, body) of one request, no retries."""
    conn = http.client.HTTPConnection(url.split("//")[-1], timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        keep = {k: v for k, v in r.getheaders() if k in (
            "Content-Type", "Content-Range", "ETag", "Content-Length",
            "Content-Length-Hint", "Seaweed-Color")}
        return r.status, keep, data
    finally:
        conn.close()


def _mask(obj):
    """JSON with chunk fids, hard-link ids, stamps and wall-clock times
    masked."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("file_id", "fid", "url", "publicUrl", "auth",
                     "hard_link_id"):
                out[k] = "<fid>" if v else v
            elif k in ("mtime", "crtime", "Mtime", "ts_ns", "now_ns"):
                out[k] = "<t>"
            else:
                out[k] = _mask(v)
        return out
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _body(resp):
    status, headers, data = resp
    if headers.get("Content-Type", "").startswith("application/json"):
        # a float time's digits set the length: the parsed body speaks
        headers = dict(headers)
        headers.pop("Content-Length", None)
        data = _mask(json.loads(data))
    return status, headers, data


def _truncated_post(url, path):
    host, port = url.split("//")[-1].split(":")
    s = socket.create_connection((host, int(port)), timeout=10)
    s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: 5000\r\n"
              "Connection: close\r\n\r\n".encode() + b"A" * 700)
    s.shutdown(socket.SHUT_WR)
    resp = b""
    while piece := s.recv(65536):
        resp += piece
    s.close()
    return resp.split(b"\r\n", 1)[0]


def _sequence(f, read_fid):
    """The request sequence against filer URL ``f``; ``read_fid(fid)``
    says whether a chunk still reads from the volume tier."""
    rng = np.random.default_rng(RNG_SEED)
    blob = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    text = (b"the quick brown fox " * 300)
    obs = []

    def do(method, path, body=None, headers=None):
        obs.append((method, path, _body(call(f, method, path, body,
                                             headers))))

    do("POST", "/docs/hello.txt", b"hello filer",
       {"Content-Type": "text/plain"})
    do("GET", "/docs/hello.txt")
    do("POST", "/big/blob.bin", blob)
    do("POST", "/big/words.txt", text, {"Content-Type": "text/plain"})
    do("POST", "/big/exact.bin", blob[:2048])
    do("POST", "/empty.bin", b"")
    for path in ("/big/blob.bin", "/big/words.txt", "/big/exact.bin",
                 "/empty.bin"):
        do("GET", path)
    for rng_hdr in ("bytes=1000-2999", "bytes=-100", "bytes=9990-",
                    "bytes=0-0", "bytes=20000-30000", "bytes=5000-4000"):
        do("GET", "/big/blob.bin", headers={"Range": rng_hdr})
    do("GET", "/empty.bin", headers={"Range": "bytes=0-1"})
    do("HEAD", "/big/blob.bin")
    do("GET", "/big/blob.bin?meta=true")
    meta = json.loads(call(f, "GET", "/big/blob.bin?meta=true")[2])
    fids = [c["file_id"] for c in meta["chunks"]]
    do("POST", "/color.txt", b"red", {"Seaweed-Color": "red",
                                      "X-Amz-Meta-A": "b"})
    do("GET", "/color.txt")
    for i in range(5):
        do("POST", f"/list/f{i:02d}.txt", b"x" * (i + 1))
    do("GET", "/list/?limit=3")
    do("GET", "/list/?limit=10&lastFileName=f02.txt")
    do("GET", "/list")
    do("GET", "/")
    do("POST", "/mv/dst.txt?mv.from=/docs/hello.txt", b"")
    do("GET", "/docs/hello.txt")
    do("GET", "/mv/dst.txt")
    do("POST", "/ln/b.txt?ln.from=/mv/dst.txt", b"")
    do("POST", "/ln/b.txt?ln.from=/mv/dst.txt", b"")
    do("POST", "/ln/c.txt?ln.from=/nope", b"")
    do("POST", "/ln/d.txt?ln.from=/list", b"")
    do("GET", "/ln/b.txt")
    do("GET", "/ln/?limit=5")
    do("POST", "/made/dir/", b"")
    do("GET", "/made/dir/")
    do("POST", "/raw/entry.bin?entry=true", json.dumps(
        {"attr": {"mode": 0o644, "mime": "x/y", "file_size": 0}}).encode())
    do("GET", "/raw/entry.bin?meta=true")
    do("DELETE", "/list")
    do("DELETE", "/list?recursive=true")
    do("GET", "/list/f00.txt")
    do("PUT", "/__kv/key%201", b"value-1")
    do("GET", "/__kv/key%201")
    do("DELETE", "/__kv/key%201")
    do("GET", "/__kv/key%201")
    do("PATCH", "/__kv/x")
    status, _, body = call(f, "GET", "/__assign?count=2")
    obs.append(("assign", status, sorted(json.loads(body))))
    obs.append(("truncated", _truncated_post(f, "/trunc/cut.bin")))
    do("GET", "/trunc/cut.bin")
    do("DELETE", "/big/blob.bin")
    do("GET", "/big/blob.bin")
    obs.append(("gc", [read_fid(fid) for fid in fids]))
    events = json.loads(call(f, "GET", "/meta/events?since=0")[2])
    obs.append(("events", _mask(events)))
    status, _, metrics = call(f, "GET", "/metrics")
    obs.append(("metrics", status,
                b'seaweedfs_server_uptime_seconds{component="filer"}'
                in metrics))
    return obs


def _readable(op_mod, master):
    def read(fid):
        try:
            op_mod.read_file(master, fid)
            return True
        except Exception:
            return False
    return read


def test_http_sequence_matches_reference(tmp_path):
    got = {}
    for which, harness, filer_cls, op_mod in (
            ("ref", RefClusterHarness, RefFilerServer, ref_operation),
            ("port", ClusterHarness, FilerServer, port_operation)):
        _reset_clients()
        kw = {"device": "cpu"} if which == "port" else {}
        with harness(n_volume_servers=2, volumes_per_server=20,
                     root=str(tmp_path / which), **kw) as c:
            c.wait_for_nodes(2)
            fs = filer_cls(c.master.url, chunk_size=1024,
                           telemetry_interval=0)
            fs.start()
            try:
                got[which] = _sequence(
                    fs.url, _readable(op_mod, c.master.url))
            finally:
                fs.stop()
    _reset_clients()
    for a, b in zip(got["port"], got["ref"]):
        assert a == b  # the first step that differs
    assert got["port"] == got["ref"]
    seq = dict((o[1], o[2]) for o in got["port"] if o[0] == "GET"
               and o[1] == "/big/blob.bin")
    assert seq["/big/blob.bin"][0] == 404  # the last GET, after delete
    gc = [o for o in got["port"] if o[0] == "gc"][0][1]
    assert gc and not any(gc)
    assert any(o[0] == "truncated" and b" 400 " in o[1]
               for o in got["port"])


@pytest.mark.parametrize("direction", ["port_filer_ref_cluster",
                                       "ref_filer_port_cluster"])
def test_mixed_cluster(direction, tmp_path):
    _reset_clients()
    if direction == "port_filer_ref_cluster":
        harness, filer_cls, op_mod, kw = (RefClusterHarness, FilerServer,
                                          ref_operation, {})
    else:
        harness, filer_cls, op_mod, kw = (ClusterHarness, RefFilerServer,
                                          port_operation, {"device": "cpu"})
    rng = np.random.default_rng([RNG_SEED, 2])
    files = {f"/mix/d{i % 2}/f{i}.bin": rng.integers(
        0, 256, 300 + 1700 * i, dtype=np.uint8).tobytes() for i in range(6)}
    try:
        with harness(n_volume_servers=2, volumes_per_server=20,
                     root=str(tmp_path / "c"), **kw) as c:
            c.wait_for_nodes(2)
            fs = filer_cls(c.master.url, chunk_size=1024,
                           telemetry_interval=0)
            fs.start()
            try:
                f = fs.url
                for path, data in files.items():
                    assert call(f, "POST", path, data)[0] in (200, 201)
                for path, data in files.items():
                    assert call(f, "GET", path)[2] == data, path
                listing = json.loads(call(f, "GET", "/mix/d0/")[2])
                assert [e["FullPath"] for e in listing["Entries"]] == [
                    p for p in sorted(files) if p.startswith("/mix/d0/")]
                assert call(f, "POST", "/moved.bin?mv.from=/mix/d1/f5.bin",
                            b"")[0] == 200
                assert call(f, "GET", "/moved.bin")[2] == files[
                    "/mix/d1/f5.bin"]
                meta = json.loads(call(f, "GET", "/moved.bin?meta=true")[2])
                fids = [ch["file_id"] for ch in meta["chunks"]]
                assert len(fids) == 9  # 8,800 bytes in 1,024-byte chunks
                assert call(f, "DELETE", "/moved.bin")[0] == 204
                read = _readable(op_mod, c.master.url)
                assert not any(read(fid) for fid in fids)
            finally:
                fs.stop()
    finally:
        _reset_clients()


def test_degraded_ec_read_through_port_filer(tmp_path):
    """Files whose chunks sit in one EC-encoded volume with shards
    {0, 5, 11, 13} deleted read back byte-exact through a port filer
    restarted over its sqlite store (no chunk served from its cache)."""
    _reset_clients()
    rng = np.random.default_rng([RNG_SEED, 3])
    files = {f"/ec/f{i:02d}.bin": rng.integers(
        0, 256, 2000 + 2900 * i, dtype=np.uint8).tobytes() for i in range(10)}
    db = str(tmp_path / "filer.db")
    try:
        with ClusterHarness(n_volume_servers=4, volumes_per_server=10,
                            root=str(tmp_path / "c"), device="cpu") as c:
            c.wait_for_nodes(4)
            m = c.master.url
            fs = FilerServer(m, store=SqliteStore(db), chunk_size=4096,
                             collection="ecf", telemetry_interval=0)
            fs.start()
            try:
                for path, data in files.items():
                    assert call(fs.url, "POST", path, data)[0] in (200, 201)
                vids = {}
                for path in files:
                    meta = json.loads(call(fs.url, "GET",
                                           path + "?meta=true")[2])
                    for ch in meta["chunks"]:
                        vid = int(ch["file_id"].split(",")[0])
                        vids.setdefault(vid, set()).add(path)
            finally:
                fs.stop()
            vid = max(vids, key=lambda v: len(vids[v]))
            env = CommandEnv(m)
            env.lock()
            try:
                out = run_command(
                    env, f"ec.encode -volumeId {vid} -collection ecf")
            finally:
                env.unlock()
            assert f"volume {vid}: ec.encode done" in out
            c.settle(5)
            lost = {0, 5, 11, 13}
            shards = port_http.get_json(f"{m}/ec/lookup?volumeId={vid}")
            for sid, locs in shards["shards"].items():
                if int(sid) in lost:
                    for loc in locs:
                        port_http.post_json(
                            f"{loc['url']}/admin/ec/delete_shards",
                            {"volume": vid, "collection": "ecf",
                             "shard_ids": [int(sid)]})
            deadline = time.time() + 30
            while time.time() < deadline:
                shards = port_http.get_json(
                    f"{m}/ec/lookup?volumeId={vid}")
                if not lost & {int(s) for s in shards["shards"]}:
                    break
                time.sleep(0.1)
            assert not lost & {int(s) for s in shards["shards"]}
            fs = FilerServer(m, store=SqliteStore(db), chunk_size=4096,
                             collection="ecf", telemetry_interval=0)
            fs.start()
            try:
                for path in sorted(vids[vid]):
                    assert call(fs.url, "GET", path)[2] == files[path], path
                for path, data in files.items():
                    assert call(fs.url, "GET", path)[2] == data, path
            finally:
                fs.stop()
            assert os.path.exists(db)
    finally:
        _reset_clients()


def test_filer_metric_families_match_reference():
    from seaweedfs_tpu.stats import metrics as ref_metrics
    from seaweedfs_tpu_torch.stats import metrics as port_metrics

    def shape(m):
        return (type(m).__name__, m.name, m.help, tuple(m.label_names),
                getattr(m, "buckets", None))

    for name in ("FILER_REQUESTS", "FILER_LATENCY", "FILER_RING_RESOLVES",
                 "FILER_CROSS_RENAMES"):
        assert shape(getattr(port_metrics, name)) == shape(
            getattr(ref_metrics, name)), name


@pytest.mark.parametrize("auth", ["none", "bad", "good"])
def test_kv_under_a_signing_key_matches_reference(auth):
    """With a signing key the filer's KV routes want a token minted with
    it, in both packages; the object namespace is untouched."""
    from seaweedfs_tpu_torch.security import jwt as port_jwt

    headers = {"none": {}, "bad": {"Authorization": "BEARER x.y.z"},
               "good": {"Authorization": "BEARER " + port_jwt.gen_jwt(
                   "sekrit", "")}}[auth]
    got = {}
    for which, cls in (("ref", RefFilerServer), ("port", FilerServer)):
        fs = cls("127.0.0.1:9", jwt_signing_key="sekrit",
                 watch_locations=False, telemetry_interval=0)
        fs.start()
        try:
            got[which] = [
                _body(call(fs.url, "PUT", "/__kv/k", b"v", headers))[:1],
                _body(call(fs.url, "GET", "/__kv/k", None, headers)),
                _body(call(fs.url, "GET", "/", None))[0]]
        finally:
            fs.stop()
    assert got["port"] == got["ref"]
    want = 200 if auth == "good" else 401
    assert got["port"][0] == (want,) and got["port"][2] == 200
