"""The port's replication (``replication/``), the filer's ``filer_peers``
and ``notification/`` held against the reference's on the CPU.

(a) ``FilerSync`` both ways between two filers — two port filers, a port
    filer and a reference one (either side), and, for the reference's
    answers, two reference filers under the reference's ``FilerSync``:
    files seeded on each side cross over, more pumps add no event (the
    sync markers stop the loop), a delete crosses over, and each target
    keeps its offset checkpoint. Every stack gives the reference's
    observations.
(b) ``Replicator`` over one filer's meta events: into a ``LocalSink``,
    the port's and the reference's give equal trees, and into a
    ``FilerSink`` on a second filer equal files; from a filer of either
    package.
(c) ``FilerServer(filer_peers=...)`` of each package: a file written on
    the peer reaches it, tagged with the peer's sync marker.
(d) ``NotificationPublisher`` over a ``Filer`` of each package on a
    pinned clock: the memory queue's messages, the log queue's lines and
    the broker queue's POSTs (to a stub broker, and its silence when the
    broker is down) are equal.
"""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import filer as ref_filer_pkg  # noqa: E402
from seaweedfs_tpu import notification as ref_notification  # noqa: E402
from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu import replication as ref_replication  # noqa: E402
from seaweedfs_tpu.server.filer import (  # noqa: E402
    FilerServer as RefFilerServer,
)
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import filer as port_filer_pkg  # noqa: E402
from seaweedfs_tpu_torch import notification as port_notification  # noqa: E402,E501
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch import replication as port_replication  # noqa: E402,E501
from seaweedfs_tpu_torch.server.filer import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

FILERS = {"ref": RefFilerServer, "port": FilerServer}
REPLICATION = {"ref": ref_replication, "port": port_replication}
STAMP_NS = 1_700_000_000_000_000_000


def _reset_clients():
    for op, retry in ((port_operation, port_retry),
                      (ref_operation, ref_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("replication")
    _reset_clients()
    with RefClusterHarness(n_volume_servers=1, volumes_per_server=30,
                           root=str(root / "ref")) as ref, \
            ClusterHarness(n_volume_servers=1, volumes_per_server=30,
                           root=str(root / "port"), device="cpu") as port:
        ref.wait_for_nodes(1)
        port.wait_for_nodes(1)
        yield {"ref": ref, "port": port}
    _reset_clients()


def _filer(which, clusters, **kw):
    fs = FILERS[which](clusters[which].master.url, telemetry_interval=0,
                       **kw)
    fs.start()
    return fs


def _events(url):
    return len(http.get_json(f"{url}/meta/events?since=0")["events"])


def _read(url, path):
    try:
        return http.request("GET", f"{url}{path}")
    except http.HttpError as e:
        return e.status


def _sync_run(sync_pkg, a_pkg, b_pkg, clusters):
    fa, fb = _filer(a_pkg, clusters), _filer(b_pkg, clusters)
    try:
        sync = REPLICATION[sync_pkg].FilerSync(fa.url, fb.url,
                                               poll_seconds=0.05)
        http.request("POST", f"{fa.url}/docs/from_a.txt", b"AAA")
        http.request("POST", f"{fb.url}/docs/from_b.txt", b"BBB" * 999)
        http.request("POST", f"{fa.url}/docs/sub/deep.bin", b"D" * 5000)
        obs = [("first pumps", sync.pump_once(), sync.pump_once())]
        obs.append(("crossed", _read(fb.url, "/docs/from_a.txt"),
                    _read(fa.url, "/docs/from_b.txt"),
                    _read(fb.url, "/docs/sub/deep.bin")))
        before = (_events(fa.url), _events(fb.url))
        obs.append(("more pumps", [sync.pump_once() for _ in range(3)]))
        obs.append(("no event storm",
                    (_events(fa.url), _events(fb.url)) == before))
        http.request("DELETE", f"{fa.url}/docs/from_a.txt")
        obs.append(("delete pump", sync.pump_once()))
        obs.append(("deleted", _read(fb.url, "/docs/from_a.txt"),
                    _read(fa.url, "/docs/from_a.txt")))
        marker = json.loads(http.request(
            "GET", f"{fb.url}/docs/sub/deep.bin?meta=true")).get(
            "extended") or {}
        obs.append(("marker", sorted(
            (k, v.replace(fa.url, "<a>")) for k, v in marker.items()
            if k.lower() == "seaweed-sync-source")))
        for name, url, src in (("a", fa.url, fb.url), ("b", fb.url, fa.url)):
            raw = http.request("GET", f"{url}/__kv/sync.offset.{src}")
            obs.append((f"checkpoint on {name}", int(raw) > 0))
        return obs
    finally:
        fa.stop()
        fb.stop()
        _reset_clients()


@pytest.fixture(scope="module")
def reference_sync(clusters):
    return _sync_run("ref", "ref", "ref", clusters)


@pytest.mark.parametrize("a_pkg,b_pkg", [("port", "port"), ("port", "ref"),
                                         ("ref", "port")])
def test_filer_sync_matches_reference(a_pkg, b_pkg, clusters,
                                      reference_sync):
    got = _sync_run("port", a_pkg, b_pkg, clusters)
    assert got == reference_sync
    out = {o[0]: o[1:] for o in got}
    assert out["crossed"] == (b"AAA", b"BBB" * 999, b"D" * 5000)
    assert out["no event storm"] == (True,)
    assert out["deleted"] == (404, 404)
    assert out["marker"] == ([("Seaweed-Sync-Source", "sync:<a>")],)


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("source", ["ref", "port"])
def test_replicator_trees_match_reference(source, clusters, tmp_path):
    src = _filer(source, clusters)
    dst = {which: _filer(which, clusters) for which in REPLICATION}
    try:
        reps = {}
        for which, mod in REPLICATION.items():
            reps[which] = (
                mod.Replicator(src.url, mod.LocalSink(
                    str(tmp_path / which)), "/rep", "/mirror"),
                mod.Replicator(src.url, mod.FilerSink(
                    dst[which].url, source_id=f"sync:{which}"), "/rep",
                    "/copy"))
        applied = {which: [] for which in REPLICATION}
        since = 0
        # each write's events are replayed before the next write, as a
        # live subscriber sees them (a create replayed after its delete
        # finds no content to fetch)
        for method, path, body in (
                ("POST", "/rep/a.txt", b"replicate me"),
                ("POST", "/rep/d/b.bin", b"B" * 3000),
                ("POST", "/rep/d/e/c.txt", b"c"),
                ("POST", "/other/x.txt", b"outside the prefix"),
                ("POST", "/rep/a.txt", b"overwritten"),
                ("POST", "/rep/gone.txt", b"soon deleted"),
                ("DELETE", "/rep/gone.txt", None)):
            http.request(method, f"{src.url}{path}", body,
                         {"Content-Type": "text/plain"})
            events = http.get_json(
                f"{src.url}/meta/events?since={since}")["events"]
            for ev in events:
                since = max(since, ev["ts_ns"])
                for which, (local, remote) in reps.items():
                    applied[which].append((local.replicate_event(ev),
                                           remote.replicate_event(ev)))
        got = {}
        for which in REPLICATION:
            copied = {p: _read(dst[which].url, f"/copy{p}")
                      for p in ("/a.txt", "/d/b.bin", "/d/e/c.txt",
                                "/gone.txt")}
            got[which] = (applied[which], _tree(tmp_path / which), copied)
        assert got["port"] == got["ref"]
        applied, tree, copied = got["port"]
        assert tree == {"mirror/a.txt": b"overwritten",
                        "mirror/d/b.bin": b"B" * 3000,
                        "mirror/d/e/c.txt": b"c"}
        assert copied == {"/a.txt": b"overwritten", "/d/b.bin": b"B" * 3000,
                          "/d/e/c.txt": b"c", "/gone.txt": 404}
        assert any(a for a, _ in applied) and not all(a for a, _ in applied)
    finally:
        for fs in (src, *dst.values()):
            fs.stop()
        _reset_clients()


def test_filer_peers_matches_reference(clusters):
    got = {}
    for which in ("ref", "port"):
        peer = _filer(which, clusters)
        fs = _filer(which, clusters, filer_peers=[peer.url])
        try:
            http.request("POST", f"{peer.url}/peer/p.txt", b"from the peer")
            deadline = time.monotonic() + 30
            while _read(fs.url, "/peer/p.txt") != b"from the peer":
                assert time.monotonic() < deadline, which
                time.sleep(0.05)
            ext = json.loads(http.request(
                "GET", f"{fs.url}/peer/p.txt?meta=true")).get("extended")
            got[which] = {k: v.replace(peer.url, "<peer>")
                          for k, v in (ext or {}).items()}
            # the peer is not written back: a one-way aggregator
            assert _read(peer.url, "/peer/p.txt") == b"from the peer"
        finally:
            fs.stop()
            peer.stop()
            _reset_clients()
    assert got["port"] == got["ref"] == {
        "Seaweed-Sync-Source": "sync:<peer>"}


def _masked(obj):
    """Entry times masked: ``Attr``'s default times bind ``time.time``
    when the class is made, before any pin."""
    if isinstance(obj, dict):
        return {k: "<t>" if k in ("mtime", "crtime") else _masked(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _notify_run(filer_pkg, notification, tmp_path, monkeypatch,
                broker_url):
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    monkeypatch.setattr(time, "time", lambda: STAMP_NS / 1e9)
    mem = notification.MemoryQueue()
    log = notification.LogQueue(str(tmp_path / "events.log"))
    broker = notification.BrokerQueue(broker_url, topic="meta")
    down = notification.BrokerQueue("http://127.0.0.1:9")
    f = filer_pkg.Filer(filer_pkg.MemoryStore())
    f.subscribe(notification.NotificationPublisher([mem, log, broker,
                                                    down]))
    Entry = filer_pkg.Entry
    f.create_entry(Entry(full_path="/n/x.txt"))
    f.create_entry(Entry(full_path="/n/d/y.txt"))
    f.update_entry(Entry(full_path="/n/x.txt"))
    f.delete_entry("/n/x.txt")
    lines = (tmp_path / "events.log").read_text().splitlines()
    return _masked(mem.messages), _masked([json.loads(ln) for ln in lines])


def test_notification_queues_match_reference(tmp_path, monkeypatch):
    posts = []

    def publish(req):
        posts.append(req.json())
        return http.Response.json({"ok": True})

    router = http.Router()
    router.add("POST", r"/publish", publish)
    stub = http.HttpServer(router, "127.0.0.1", 0)
    stub.start()
    got = {}
    try:
        for which, filer_pkg, notification in (
                ("ref", ref_filer_pkg, ref_notification),
                ("port", port_filer_pkg, port_notification)):
            (tmp_path / which).mkdir()
            start = len(posts)
            mem, log = _notify_run(filer_pkg, notification,
                                   tmp_path / which, monkeypatch, stub.url)
            sent = [dict(p, value=_masked(json.loads(p["value"])))
                    for p in posts[start:]]
            got[which] = (mem, log, sent)
    finally:
        stub.stop()
    assert got["port"] == got["ref"]
    mem, log, sent = got["port"]
    assert mem == log and len(sent) == len(mem) >= 4
    assert [m["event_type"] for m in mem][-1] == "delete"
    assert all(p["topic"] == "meta" and p["value"]["ts_ns"] == STAMP_NS
               for p in sent)
