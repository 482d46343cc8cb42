"""The port's host base of the volume server — ``util/`` (http, retry,
glog, config, limiter, compression), ``fault``'s ``/admin/fault`` routes,
``pb/``, ``security/jwt`` — held against the reference on the CPU, on
seeded inputs, with 0 differing bytes: a port ``HttpServer`` answered by
the reference client and a reference server answered by the port
client, chunked and streamed bodies, ``parse_multipart``,
``Retry-After``, ``Policy.backoff`` under one seeded ``random``, the
breaker's transitions, JWTs minted by one package and decoded by the
other, and ``Heartbeat.to_dict()``."""

import gzip
import json
import random
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu import fault as ref_fault  # noqa: E402
from seaweedfs_tpu.pb import messages as ref_pb  # noqa: E402
from seaweedfs_tpu.security import jwt as ref_jwt  # noqa: E402
from seaweedfs_tpu.util import compression as ref_comp  # noqa: E402
from seaweedfs_tpu.util import config as ref_config  # noqa: E402
from seaweedfs_tpu.util import glog as ref_glog  # noqa: E402
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu.util import limiter as ref_limiter  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import fault as port_fault  # noqa: E402
from seaweedfs_tpu_torch.pb import messages as port_pb  # noqa: E402
from seaweedfs_tpu_torch.security import jwt as port_jwt  # noqa: E402
from seaweedfs_tpu_torch.util import compression as port_comp  # noqa: E402
from seaweedfs_tpu_torch.util import config as port_config  # noqa: E402
from seaweedfs_tpu_torch.util import glog as port_glog  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import limiter as port_limiter  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

HTTP = {"ref": ref_http, "port": port_http}
RETRY = {"ref": ref_retry, "port": port_retry}
FAULT = {"ref": ref_fault, "port": port_fault}
SEED = 12


@pytest.fixture(autouse=True)
def clean_breakers():
    """Breakers are per package and process-global: every case starts
    and ends with both packages' closed."""
    for mod in RETRY.values():
        mod.BREAKERS.reset()
    yield
    for mod in RETRY.values():
        mod.BREAKERS.reset()


def _payload(n: int, salt: int = 0) -> bytes:
    return np.random.default_rng([SEED, salt]).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _router(h):
    """The same handler set on either package's Router."""
    state = {"busy": 0}
    r = h.Router()
    r.add("GET", r"/json", lambda req: h.Response.json(
        {"q": req.param("q"), "path": req.path}))
    r.add("POST", r"/echo", lambda req: h.Response(
        body=req.body, headers={"X-Len": str(len(req.body))}))
    r.add("PUT", r"/sum", lambda req: h.Response.json(
        {"n": len(req.reader.readall())}))

    def stream(req):
        n = int(req.param("n"))
        data = _payload(n, 1)
        pieces = (data[i:i + 777] for i in range(0, n, 777))
        known = req.param("known") == "1"
        return h.Response(stream=pieces,
                          content_length=n if known else None)

    r.add("GET", r"/stream", stream)

    def busy(req):
        state["busy"] += 1
        if state["busy"] % 2:
            return h.Response(status=503, body=b"busy",
                              headers={"Retry-After": "0.2"})
        return h.Response.json({"after": state["busy"]})

    r.add("GET", r"/busy", busy)
    r.add("GET", r"/missing", lambda req: h.Response.error("gone", 404))
    return r


def _exchange(server: str, client: str) -> list:
    """Requests of one package's client against the other's server;
    every observation the two sides can differ in."""
    hs, hc = HTTP[server], HTTP[client]
    srv = hs.HttpServer(_router(hs))
    srv.start()
    out = []
    try:
        u = srv.url
        out.append(hc.get_json(f"{u}/json?q=a%20b"))
        body = _payload(70_001, 2)
        out.append(hc.request("POST", f"{u}/echo", body))
        # an iterator body goes out chunked
        out.append(hc.request(
            "PUT", f"{u}/sum", iter([body[:5000], body[5000:]])))
        out.append(hc.request("GET", f"{u}/stream?n=100003"))
        out.append(hc.request("GET", f"{u}/stream?n=100003&known=1"))
        with hc.request_stream("GET", f"{u}/stream?n=9999") as r:
            out.append(b"".join(r.iter(1000)))
        with pytest.raises(hc.HttpError) as ei:
            hc.request("GET", f"{u}/missing")
        out.append((ei.value.status, ei.value.body))
        with pytest.raises(hc.HttpError) as ei:
            hc.request("GET", f"{u}/busy")
        out.append((ei.value.status, ei.value.retry_after))
        t0 = time.time()
        out.append(hc.get_json(
            f"{u}/busy", retry=RETRY[client].Policy(
                max_attempts=3, base_delay=0.001, max_delay=0.002)))
        out.append(time.time() - t0 >= 0.2)  # Retry-After is a floor
    finally:
        srv.stop()
    return out


@pytest.mark.parametrize("server,client", [
    ("port", "ref"), ("ref", "port"), ("port", "port")])
def test_server_and_client_against_the_reference(server, client):
    assert _exchange(server, client) == _exchange("ref", "ref")


MULTIPART_CASES = [
    # (boundary, parts: (name, filename, mime, data))
    ("XyZ", [("file", "a/b.bin", "application/octet-stream",
              _payload(5000, 3))]),
    ("b0und", [("meta", None, "", b"k=v"),
               ("file", "p.jpg", "image/jpeg", _payload(321, 4))]),
    # a payload holding "--boundary" mid-line is not split
    ("zz", [("file", "x", "text/plain",
             b"head--zz tail\r\nmore--zz" + _payload(64, 5))]),
]


def _multipart(boundary, parts) -> bytes:
    out = b""
    for name, filename, mime, data in parts:
        cd = f'form-data; name="{name}"'
        if filename is not None:
            cd += f'; filename="{filename}"'
        head = f"--{boundary}\r\nContent-Disposition: {cd}\r\n"
        if mime:
            head += f"Content-Type: {mime}\r\n"
        out += head.encode() + b"\r\n" + data + b"\r\n"
    return out + f"--{boundary}--\r\n".encode()


@pytest.mark.parametrize("boundary,parts", MULTIPART_CASES)
def test_parse_multipart(boundary, parts):
    body = _multipart(boundary, parts)
    ctype = f"multipart/form-data; boundary={boundary}"
    got = [vars(p) for p in port_http.parse_multipart(body, ctype)]
    assert got == [vars(p) for p in ref_http.parse_multipart(body, ctype)]
    assert [p["data"] for p in got] == [d for *_, d in parts]
    with pytest.raises(ValueError):
        port_http.parse_multipart(body, "multipart/form-data")


def test_policy_backoff_under_one_seeded_random(monkeypatch):
    draws = {}
    for name, mod in RETRY.items():
        monkeypatch.setattr(mod, "_rng", random.Random(SEED))
        pols = [mod.DEFAULT, mod.LOOKUP, mod.REPLICATE, mod.UPLOAD,
                mod.ADMIN, mod.Policy(base_delay=0.3, max_delay=1.5)]
        draws[name] = [p.backoff(a) for p in pols for a in range(8)]
    assert draws["port"] == draws["ref"]
    for name in ("DEFAULT", "LOOKUP", "REPLICATE", "UPLOAD", "ADMIN",
                 "ADMIN_LONG"):
        assert vars(getattr(port_retry, name)) == vars(
            getattr(ref_retry, name))
    for status in (0, 200, 404, 429, 500, 502, 503, 504):
        for refused in (False, True):
            assert port_retry.retriable(status, refused) == \
                ref_retry.retriable(status, refused)


def _breaker_walk(mod) -> list:
    """closed → open at threshold → half-open probe after cooldown →
    open on probe failure → closed on probe success."""
    reg = mod.CircuitBreakerRegistry(threshold=3, window=5.0,
                                     cooldown=0.15)
    peer = "10.0.0.1:8080"
    seen = []
    for _ in range(3):
        reg.check(peer)
        reg.record(peer, ok=False)
        seen.append(reg.state(peer))
    with pytest.raises(mod.BreakerOpen):
        reg.check(peer)
    time.sleep(0.2)
    reg.check(peer)  # this caller becomes the half-open probe
    seen.append(reg.state(peer))
    with pytest.raises(mod.BreakerOpen):
        reg.check(peer)  # only one probe at a time
    reg.record(peer, ok=False)
    seen.append(reg.state(peer))
    time.sleep(0.2)
    reg.check(peer)
    reg.record(peer, ok=True)
    seen.append(reg.state(peer))
    reg.check(peer)
    seen.append(sorted(reg.snapshot()))
    return seen


def test_breaker_transitions():
    assert _breaker_walk(port_retry) == _breaker_walk(ref_retry)


def test_deadline_header_and_scope():
    for mod in RETRY.values():
        assert mod.DEADLINE_HEADER == "X-Seaweed-Deadline"
    hdr = {"X-Seaweed-Deadline": "1700000000.250000"}
    assert port_retry.parse_deadline_header(hdr) == \
        ref_retry.parse_deadline_header(hdr)
    with port_retry.deadline_scope(0.05):
        assert 0 < port_retry.remaining() <= 0.05
        time.sleep(0.06)
        with pytest.raises(port_http.HttpError) as ei:
            port_http.request("GET", "http://127.0.0.1:9/x")
        assert ei.value.deadline_exceeded
    assert port_retry.deadline() is None


def test_breaker_fails_fast_on_dead_peer():
    dead = "127.0.0.1:1"  # nothing listens on port 1
    for _ in range(6):
        with pytest.raises(port_http.HttpError):
            port_http.request("GET", f"http://{dead}/x", timeout=2)
    with pytest.raises(port_http.HttpError) as ei:
        port_http.request("GET", f"http://{dead}/x", timeout=2)
    assert ei.value.circuit_open
    # the reference's breakers are its own
    assert ref_retry.BREAKERS.state(dead) == "closed"


def _fault_calls(pkg, monkeypatch, armed: bool) -> list:
    h, f = HTTP[pkg], FAULT[pkg]
    if armed:
        monkeypatch.setenv("SEAWEEDFS_FAULTS_ADMIN", "1")
    else:
        monkeypatch.delenv("SEAWEEDFS_FAULTS_ADMIN", raising=False)
    r = h.Router()
    f.install_routes(r)
    srv = h.HttpServer(r)
    srv.start()
    out = []
    try:
        for method, path, body in (
            ("GET", "/admin/fault", None),
            ("POST", "/admin/fault", {"point": "ec.shard.read",
                                      "kind": "error", "count": 2,
                                      "seed": 7}),
            ("GET", "/admin/fault", None),
            ("POST", "/admin/fault", {"action": "bogus"}),
            ("POST", "/admin/fault", {"point": "x", "kind": "nope"}),
            ("POST", "/admin/fault", {"action": "clear"}),
        ):
            data = None if body is None else json.dumps(body).encode()
            try:
                out.append((200, json.loads(
                    h.request(method, f"{srv.url}{path}", data))))
            except h.HttpError as e:
                out.append((e.status, json.loads(e.body)))
    finally:
        srv.stop()
        f.REGISTRY.clear()
    return out


@pytest.mark.parametrize("armed", [False, True])
def test_admin_fault_routes(monkeypatch, armed):
    port = _fault_calls("port", monkeypatch, armed)
    assert port == _fault_calls("ref", monkeypatch, armed)
    assert port[0][0] == (200 if armed else 403)


@pytest.mark.parametrize("minted_by,decoded_by", [
    ("port", "ref"), ("ref", "port")])
def test_jwt_across_packages(minted_by, decoded_by, monkeypatch):
    mods = {"ref": ref_jwt, "port": port_jwt}
    monkeypatch.setattr(ref_jwt.time, "time", lambda: 1_700_000_000.5)
    token = mods[minted_by].gen_jwt("sekrit", "3,01637037d6", 60)
    assert token == mods[decoded_by].gen_jwt("sekrit", "3,01637037d6", 60)
    claims = mods[decoded_by].decode_jwt("sekrit", token)
    assert claims == {"exp": 1_700_000_060, "sub": "3,01637037d6"}
    guard = mods[decoded_by].Guard(signing_key="sekrit")
    assert guard.is_active
    guard.check_jwt(token, "3,01637037d6")
    with pytest.raises(mods[decoded_by].JwtError):
        guard.check_jwt(token, "3,01637037d7")
    with pytest.raises(mods[decoded_by].JwtError):
        mods[decoded_by].decode_jwt("other", token)
    assert mods[minted_by].gen_jwt("", "3,01") == ""


def _heartbeat(pb):
    rng = np.random.default_rng(SEED)
    vols = [pb.VolumeInformationMessage(
        id=int(i), size=int(rng.integers(1 << 30)), collection="c",
        file_count=int(rng.integers(1000)), read_only=bool(i % 2),
        replica_placement=1, ttl=int(rng.integers(1 << 16)),
        modified_at_second=1_700_000_000 + int(i)) for i in range(3)]
    ecs = [pb.EcShardInformationMessage(id=9, collection="c",
                                        ec_index_bits=0b10100001)]
    return pb.Heartbeat(
        ip="127.0.0.1", port=8080, public_url="127.0.0.1:8080",
        max_volume_count=7, max_file_key=123, data_center="dc1",
        rack="r1", volumes=vols, new_volumes=vols[:1],
        deleted_volumes=vols[2:], ec_shards=ecs, new_ec_shards=ecs,
        deleted_ec_shards=[], has_no_volumes=False,
        has_no_ec_shards=False, under_replicated=["3,01637037d6"])


def test_heartbeat_to_dict_and_back():
    port, ref = _heartbeat(port_pb).to_dict(), _heartbeat(ref_pb).to_dict()
    assert json.dumps(port) == json.dumps(ref)
    assert port["telemetry"] is None
    back = ref_pb.Heartbeat.from_dict(json.loads(json.dumps(port)))
    assert back.to_dict() == ref
    assert port_pb.Heartbeat.from_dict(ref).to_dict() == port
    loc = dict(url="a:1", public_url="a:1", new_vids=[1, 2], leader="m:9")
    assert port_pb.VolumeLocation(**loc).to_dict() == \
        ref_pb.VolumeLocation(**loc).to_dict()


def test_config_file_and_env(tmp_path, monkeypatch):
    (tmp_path / "filer.json").write_text(
        json.dumps({"store": "sqlite", "leveldb": {"dir": "/x"}}))
    seen = []
    for mod in (port_config, ref_config):
        monkeypatch.setattr(mod, "SEARCH_DIRS", [str(tmp_path)])
        monkeypatch.delenv("WEED_STORE", raising=False)
        cfg = mod.Configuration.load("filer")
        row = [cfg.get_string("store"), cfg.get_string("leveldb.dir"),
               cfg.get("missing", 7), mod.Configuration.load("nope").get("a")]
        monkeypatch.setenv("WEED_STORE", "memory")
        monkeypatch.setenv("WEED_FLAG", "true")
        monkeypatch.setenv("WEED_N", "42")
        row += [cfg.get_string("store"), cfg.get_bool("flag"),
                cfg.get_int("n")]
        seen.append(row)
    assert seen[0] == seen[1] == ["sqlite", "/x", 7, None, "memory",
                                  True, 42]


def test_glog_levels():
    for mod in (port_glog, ref_glog):
        mod.set_level(2)
        assert mod.V(2).enabled
        assert not mod.V(3).enabled
        mod.V(5).infof("should not appear %d", 1)  # gated
        mod.set_level(0)
    assert port_glog._logger.name == "seaweedfs_tpu_torch"


def test_concurrent_limiter():
    import threading

    lim = port_limiter.ConcurrentLimiter(3)
    active, peak = [], []
    lock = threading.Lock()

    def work():
        with lim:
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.02)
            with lock:
                active.pop()

    threads = [threading.Thread(target=work) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert max(peak) <= 3
    assert lim.try_acquire()
    lim.release()
    for mod in (port_limiter, ref_limiter):
        with pytest.raises(ValueError):
            mod.ConcurrentLimiter(0)


def test_bytes_throttler_caps_rate():
    th = port_limiter.BytesThrottler(bytes_per_second=1_000_000)
    t0 = time.monotonic()
    for _ in range(5):
        th.throttle(50_000)  # 250 KB at 1 MB/s -> >= ~0.25 s
    assert time.monotonic() - t0 >= 0.2
    th0 = port_limiter.BytesThrottler(0)
    t0 = time.monotonic()
    for _ in range(100):
        th0.throttle(10_000_000)
    assert time.monotonic() - t0 < 0.1


@pytest.mark.parametrize("mime,name,n", [
    ("text/plain", "", 5000), ("application/json", "", 300),
    ("", "x.csv", 4000), ("image/png", "a.png", 4000),
    ("text/html", "", 100)])
def test_compression(monkeypatch, mime, name, n):
    # gzip stamps the clock into its header: one clock for both
    monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)
    data = (b"seaweed " * n)[:n]
    port = port_comp.maybe_compress(data, mime, name)
    assert port == ref_comp.maybe_compress(data, mime, name)
    assert port_comp.is_compressible(mime, name) == \
        ref_comp.is_compressible(mime, name)
    if port[1]:
        assert port_comp.decompress(port[0]) == data
        assert ref_comp.decompress(port[0]) == data
    packed = ref_comp.compress(data)
    assert port_comp.decompress(packed) == data
    if port_comp.HAS_ZSTD:
        z = port_comp.compress(data, "zstd")
        assert ref_comp.decompress(z) == data
