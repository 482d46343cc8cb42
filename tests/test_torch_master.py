"""The port's master (``server/master.py``, ``server/location_watch.py``)
held against the reference on the CPU.

(a) One request sequence — heartbeats (full and delta, volumes and EC
    shards), assigns (before any node, single, batched, auto-growing a
    collection), lookups, ``/ec/lookup``, grows, the cluster lock,
    ``/cluster/status``, ``/topology``, ``/dir/status``,
    ``/vol/status``, the synchronous vacuum, ``/col/delete``, the raft
    routes and the first lines of ``/cluster/watch`` — goes to a port
    master and to a reference master, each over one stub volume server:
    the same statuses and JSON bodies, and the same calls on the stub.
    The master's URL and the watch epoch are the only values replaced;
    the assign cookies and the write pick draw from one seeded
    ``random.Random`` for each run, in place of the ``random`` module
    of each package's master and volume layout.
(b) What the port does not serve yet answers 501 or raises, and
    ``ClusterHarness()`` and volume servers under a port master raise
    without a card.
(c) The master cases of ``tests/test_cluster.py`` that need no harness:
    the heartbeat stream's reconnect storm, the bidi stream, and an
    assign from a partial growth, on port masters and port volume
    servers (``device="cpu"``).
"""

import http.client
import json
import random
import socket
import time

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.server import master as ref_master  # noqa: E402
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv  # noqa: E402
from seaweedfs_tpu.topology import volume_layout as ref_layout  # noqa: E402
from seaweedfs_tpu.shell import run_command as ref_run_command  # noqa: E402
from seaweedfs_tpu_torch import operation  # noqa: E402
from seaweedfs_tpu_torch.maintenance import MaintenancePolicy  # noqa: E402
from seaweedfs_tpu_torch.server import master as port_master  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.shell import (  # noqa: E402
    CommandEnv,
    all_commands,
    run_command,
)
from seaweedfs_tpu_torch.topology import (  # noqa: E402
    volume_layout as port_layout,
)
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402
from seaweedfs_tpu_torch.util.http import Response, Router  # noqa: E402

torch.set_num_threads(2)

SEED = 13


def call(url: str, method: str, path: str, body=None):
    """(status, Retry-After, body) of one request, no retries."""
    conn = http.client.HTTPConnection(url.split("//")[-1], timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Retry-After"), r.read()
    finally:
        conn.close()


class StubVolumeServer:
    """Answers the admin calls a master makes, and records them."""

    def __init__(self):
        self.calls = []
        router = Router()
        router.add("POST", r"/admin/.*", self._admin)
        self.server = port_http.HttpServer(router, "127.0.0.1", 0)
        self.server.start()
        self.host, port = self.server.url.split("//")[-1].rsplit(":", 1)
        self.port = int(port)

    def _admin(self, req):
        body = req.json()
        self.calls.append((req.path, body))
        if req.path == "/admin/vacuum/check":
            return Response.json({"garbage_ratio": 0.5 if body["volume"] % 2
                                  else 0.1})
        return Response.json({"ok": True})

    def stop(self):
        self.server.stop()


def _heartbeat(stub, **kw):
    hb = {"ip": stub.host, "port": stub.port, "public_url": "",
          "max_volume_count": 12, "data_center": "dc1", "rack": "r1"}
    hb.update(kw)
    return json.dumps(hb).encode()


def _vol(vid, **kw):
    v = {"id": vid, "size": 1000 * vid, "collection": "", "file_count": vid,
         "delete_count": 0, "deleted_byte_count": 0, "read_only": False,
         "replica_placement": 0, "version": 3, "ttl": 0}
    v.update(kw)
    return v


def _watch_lines(url: str, since: int = 0) -> list:
    """The lines of ``/cluster/watch`` up to its first keepalive."""
    conn = http.client.HTTPConnection(url.split("//")[-1], timeout=30)
    try:
        conn.request("GET", f"/cluster/watch?since={since}")
        r = conn.getresponse()
        lines = []
        while True:
            line = r.readline()
            if line.strip() == b"":
                return r.status, lines
            lines.append(json.loads(line))
    finally:
        conn.close()


def _sequence(master, stub) -> list:
    m = master.url
    out = []

    def do(method, path, body=None):
        out.append((method, path) + call(m, method, path, body))
        return out[-1]

    def post(path, obj):
        return do("POST", path, json.dumps(obj).encode())

    do("GET", "/cluster/status")
    do("GET", "/dir/assign")  # no node yet: 503 + Retry-After
    do("POST", "/heartbeat", _heartbeat(
        stub, volumes=[_vol(3), _vol(4, collection="c", read_only=True)],
        ec_shards=[{"id": 9, "collection": "", "ec_index_bits": 0b1011}]))
    # a second node, full (no free slot), in a DC of its own
    do("POST", "/heartbeat", json.dumps({
        "ip": "127.0.0.1", "port": 9, "max_volume_count": 1,
        "data_center": "dc2", "rack": "r9", "volumes": [_vol(5)],
        "ec_shards": [{"id": 9, "collection": "",
                       "ec_index_bits": 0b0100}]}).encode())
    for q in ("3", "4&collection=c", "9", "5,0123abcd", "77", "abc"):
        do("GET", f"/dir/lookup?volumeId={q}")
    for q in ("9", "3", "9&collection=c"):
        do("GET", f"/ec/lookup?volumeId={q}")
    do("GET", "/vol/grow?count=2")
    do("GET", "/dir/assign")
    do("GET", "/dir/assign?count=3")
    do("POST", "/dir/assign?collection=c2")  # grows the collection
    do("GET", "/dir/assign?collection=c2&count=2")
    do("GET", "/dir/assign?replication=010")  # cannot place: one rack
    do("GET", "/vol/grow?count=1&replication=100")
    post("/cluster/lock", {"client": "a"})
    post("/cluster/lock", {"client": "b"})
    post("/cluster/lock", {"client": "a"})
    post("/cluster/unlock", {"client": "a"})
    post("/cluster/lock", {"client": "b"})
    post("/cluster/unlock", {"client": "b"})
    do("POST", "/heartbeat", _heartbeat(
        stub, new_volumes=[_vol(31)], deleted_volumes=[_vol(3)],
        new_ec_shards=[{"id": 12, "collection": "e",
                        "ec_index_bits": 0b11}],
        deleted_ec_shards=[{"id": 9, "collection": "",
                            "ec_index_bits": 0b0001}]))
    for q in ("3", "31", "12"):
        do("GET", f"/dir/lookup?volumeId={q}")
    do("GET", "/ec/lookup?volumeId=12&collection=e")
    do("GET", "/topology")
    do("GET", "/dir/status")
    do("GET", "/vol/status")
    do("GET", "/cluster/status")
    do("POST", "/vol/vacuum?garbageThreshold=0.3")
    do("GET", "/col/delete?collection=c2")
    do("GET", "/topology")
    post("/raft/vote", {"term": 0, "candidate": "x", "version": 0,
                        "vterm": 0})
    out.append(("GET", "/cluster/watch") + _watch_lines(m))
    return out, list(stub.calls)


def _normalise(obj, master_url: str):
    if isinstance(obj, bytes):
        try:
            obj = json.loads(obj)
        except ValueError:
            return obj.replace(master_url.encode(), b"<master>")
    if isinstance(obj, dict):
        return {k: ("<epoch>" if k == "epoch" else _normalise(v, master_url))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalise(v, master_url) for v in obj]
    if isinstance(obj, str):
        return obj.replace(master_url, "<master>")
    return obj


def _run(kind, layout, stub, monkeypatch):
    # the assign cookies (the master's random.getrandbits) and the write
    # pick (the layout's random.choice) draw from one seeded stream; the
    # reference's tracing draws span ids from the module's own
    rng = random.Random(SEED)
    monkeypatch.setattr(kind, "random", rng)
    monkeypatch.setattr(layout, "random", rng)
    stub.calls.clear()
    # a pulse long enough that the reaper (5 pulses) never drops the
    # stub between its heartbeats, however slow the host
    master = kind.MasterServer(pulse_seconds=2.0)
    master.start()
    try:
        seq, calls = _sequence(master, stub)
        return _normalise(seq, master.url), calls
    finally:
        master.stop()


def test_request_sequence_matches_reference(monkeypatch):
    stub = StubVolumeServer()
    try:
        port_seq, port_calls = _run(port_master, port_layout, stub,
                                    monkeypatch)
        ref_seq, ref_calls = _run(ref_master, ref_layout, stub, monkeypatch)
    finally:
        stub.stop()
    assert len(port_seq) == len(ref_seq)
    for got, want in zip(port_seq, ref_seq):
        assert got == want, want[:2]
    assert port_calls == ref_calls
    # the sequence reached what it means to: an assign, a grow, a
    # vacuum, a 409, a watch replay and the stub's allocations
    statuses = {tuple(s[:2]): s[2] for s in port_seq}
    assert statuses[("GET", "/dir/assign")] == 200
    assert statuses[("POST", "/vol/vacuum?garbageThreshold=0.3")] == 200
    assert 409 in [s[2] for s in port_seq]
    assert ("/admin/assign_volume" in {p for p, _ in port_calls})
    assert port_seq[-1][2] == 200 and port_seq[-1][3][0]["reset"] is True


# -- (b) what waits answers 501 or raises ------------------------------------


def test_what_waits_answers_501_or_raises(tmp_path):
    m = port_master.MasterServer(pulse_seconds=0.2)
    m.start()
    try:
        for method in ("GET", "POST"):
            for path in ("/cluster/telemetry", "/cluster/benchmark",
                         "/cluster/maintenance"):
                status, _, body = call(m.url, method, path, b"{}")
                assert status == 501, (method, path)
                assert b"not ported" in body
        for path in ("/", "/ui"):
            assert call(m.url, "GET", path)[0] == 501
        # a heartbeat's telemetry is ignored, not refused
        hb = {"ip": "127.0.0.1", "port": 9, "max_volume_count": 1,
              "telemetry": {"component": "volume", "url": "x"}}
        status, _, body = call(m.url, "POST", "/heartbeat",
                               json.dumps(hb).encode())
        assert status == 200 and json.loads(body)["leader"] == m.url
        st = port_http.get_json(f"{m.url}/cluster/status")
        assert st == {"IsLeader": True, "Leader": m.url, "Peers": []}
        text = port_http.request("GET", f"{m.url}/metrics").decode()
        assert "# TYPE seaweedfs_master_heartbeat_total counter" in text
        # commands that are not ported raise as any unknown name does
        env = CommandEnv(m.url)
        for line in ("volume.list", "collection.list", "fs.ls /"):
            with pytest.raises(ValueError, match="unknown command"):
                run_command(env, line)
        with pytest.raises(ValueError, match="unknown command"):
            ref_run_command(RefCommandEnv(m.url), "no.such.command")
        assert sorted(all_commands()) == ["ec.balance", "ec.decode",
                                          "ec.encode", "ec.rebuild"]
    finally:
        m.stop()
    with pytest.raises(NotImplementedError):
        port_master.MasterServer(maintenance_policy=MaintenancePolicy())
    with pytest.raises(NotImplementedError):
        port_master.MasterServer(slo_error_rate=0.01)
    for kw in ({"with_filer": True}, {"with_s3": True},
               {"n_filer_shards": 2}, {"telemetry_interval": 1.0}):
        with pytest.raises(NotImplementedError):
            ClusterHarness(n_volume_servers=1, root=str(tmp_path),
                           device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        ClusterHarness(n_volume_servers=1, root=str(tmp_path),
                       device="cpu", maintenance_policy=MaintenancePolicy())


@pytest.mark.skipif("torch.cuda.is_available()")
def test_cluster_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterHarness(n_volume_servers=1, root=str(tmp_path))
    m = port_master.MasterServer(pulse_seconds=0.2)
    m.start()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VolumeServer(m.url, [str(tmp_path / "v")])
        assert not m.topo.data_nodes()
    finally:
        m.stop()


# -- (c) master cases of tests/test_cluster.py -------------------------------


def test_heartbeat_stream_reconnect_storm(tmp_path):
    n = 5
    master = port_master.MasterServer(pulse_seconds=0.2)
    master.start()
    port = int(master.url.rsplit(":", 1)[-1])
    vss = []
    try:
        for i in range(n):
            vs = VolumeServer(master.url, [str(tmp_path / f"v{i}")], [5],
                              pulse_seconds=0.2, device="cpu")
            vs.start()
            vss.append(vs)
        deadline = time.time() + 10
        while time.time() < deadline and len(master.topo.data_nodes()) < n:
            time.sleep(0.05)
        assert len(master.topo.data_nodes()) == n
        deadline = time.time() + 10
        while time.time() < deadline and any(
                vs._hb_stream is None for vs in vss):
            time.sleep(0.05)
        assert all(vs._hb_stream is not None for vs in vss)
        master.stop()
        time.sleep(0.6)
        master2 = port_master.MasterServer(port=port, pulse_seconds=0.2)
        master2.start()
        try:
            deadline = time.time() + 15
            while time.time() < deadline and not (
                    len(master2.topo.data_nodes()) == n
                    and all(vs._hb_stream is not None for vs in vss)):
                time.sleep(0.1)
            assert len(master2.topo.data_nodes()) == n
            assert all(vs._hb_stream is not None for vs in vss), (
                "some servers stuck on the POST fallback")
        finally:
            master2.stop()
    finally:
        for vs in vss:
            vs.stop()
        try:
            master.stop()
        except Exception:  # noqa: BLE001 - stopped already
            pass
        port_retry.BREAKERS.reset()


def test_heartbeat_rides_bidi_stream(tmp_path):
    m = port_master.MasterServer(pulse_seconds=0.1)
    m.start()
    vs = VolumeServer(m.url, [str(tmp_path / "v")], [5], pulse_seconds=0.1,
                      device="cpu")
    vs.start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not m.topo.data_nodes():
            time.sleep(0.05)
        assert m.topo.data_nodes()
        time.sleep(0.5)
        stream1 = vs._hb_stream
        assert stream1 is not None, "heartbeats not using the stream"
        time.sleep(0.5)
        assert vs._hb_stream is stream1, "stream re-dialed per pulse"
        stream1._sock.shutdown(socket.SHUT_RDWR)
        time.sleep(1.0)
        assert vs._hb_stream is not None
        assert vs._hb_stream is not stream1
        assert m.topo.data_nodes()
    finally:
        vs.stop()
        m.stop()


def test_assign_succeeds_with_fewer_slots_than_growth_target(tmp_path):
    m = port_master.MasterServer(pulse_seconds=0.2)
    m.start()
    vs = VolumeServer(m.url, [str(tmp_path / "v")], [5], pulse_seconds=0.2,
                      device="cpu")
    vs.start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not m.topo.data_nodes():
            time.sleep(0.05)
        fid, _ = operation.upload_data(m.url, b"partial growth ok")
        assert operation.read_file(m.url, fid) == b"partial growth ok"
        dc = next(iter(m.topo.children.values()))
        assert dc.volume_count == 5
    finally:
        vs.stop()
        m.stop()
