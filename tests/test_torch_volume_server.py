"""The port's volume server (``server/volume.py``, ``server/heartbeat_stream``)
held against the reference on the CPU.

(a) One request sequence — writes (plain, multipart, gzip, JPEG, TTL),
    reads (gzip negotiated or not, HEAD, resize), JWT checks, deletes,
    the volume admin handlers and every EC handler — against a port
    ``VolumeServer(device="cpu")`` and a reference ``VolumeServer``,
    each without a master, under one pinned record clock: the same
    statuses, bodies and files, 0 differing bytes.
(b) A mixed cluster: the reference ``MasterServer``, four port volume
    servers, the reference ``operation`` client and the reference
    shell's ``ec.encode`` → ``ec.rebuild`` → ``ec.decode``, as in
    ``tests/test_ec_workflow.py``. Every read is byte-exact before,
    during and after the encode; every shard equals the reference
    ``write_ec_files`` of the volume downloaded before it; the master's
    ``/ec/lookup`` lists shards on port servers; a ``001`` write reaches
    both replicas.
"""

import http.client
import io
import json
import os
import shutil
import threading
import time
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation  # noqa: E402
from seaweedfs_tpu.security import jwt as ref_jwt  # noqa: E402
from seaweedfs_tpu.server.master import MasterServer  # noqa: E402
from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolumeServer,
)
from seaweedfs_tpu.shell import CommandEnv, run_command  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    constants as C,
    encoder as ref_encoder,
)
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics as port_stats  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SEED = 5
KEY = "sekrit"
NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
STAMP_NS = 1_700_000_000_123_456_789
TS = "1700000000"


def call(url: str, method: str, path: str, body=None, headers=None):
    """(status, selected headers, body) of one request, no retries and
    no redirects followed."""
    u = urllib.parse.urlsplit(url if "//" in url else f"http://{url}")
    conn = http.client.HTTPConnection(u.netloc, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        keep = {k: v for k, v in r.getheaders() if k in (
            "Content-Type", "Content-Encoding", "Content-Disposition",
            "ETag", "Last-Modified-Ts", "Location", "Content-Length")}
        return r.status, keep, data
    finally:
        conn.close()


def post_json(url, path, obj, headers=None):
    return call(url, "POST", path, json.dumps(obj).encode(), headers)


def _payload(n: int, salt: int) -> bytes:
    return np.random.default_rng([SEED, salt]).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _image(fmt: str) -> bytes:
    from PIL import Image

    img = Image.new("RGB", (40, 24))
    img.putdata([((3 * i) % 256, (7 * i) % 256, (11 * i) % 256)
                 for i in range(40 * 24)])
    out = io.BytesIO()
    img.save(out, fmt)
    return out.getvalue()


def _auth(fid: str) -> dict:
    return {"Authorization": f"BEARER {ref_jwt.gen_jwt(KEY, fid, 600)}"}


def _normalise(step):
    """One step's observation with what legitimately differs taken out:
    the encode's measured timing."""
    status, headers, body = step
    try:
        obj = json.loads(body)
    except ValueError:
        return step
    if isinstance(obj, dict) and "timing" in obj:
        obj["timing"] = sorted(obj["timing"])
        body = json.dumps(obj, sort_keys=True).encode()
        headers = {k: v for k, v in headers.items()
                   if k != "Content-Length"}
    return status, headers, body


def _sequence(url: str, root) -> list:
    """The request sequence of case (a), on one server with its data
    directory at ``root``."""
    out = []

    def do(*a, **kw):
        out.append(_normalise(call(url, *a, **kw)))
        return out[-1]

    def do_json(path, obj, headers=None):
        out.append(_normalise(post_json(url, path, obj, headers)))
        return out[-1]

    do_json("/admin/assign_volume", {"volume": 3})
    do_json("/admin/assign_volume", {"volume": 4, "collection": "c"})
    do_json("/admin/assign_volume", {"volume": 5, "collection": "c",
                                     "replication": "000"})
    do_json("/admin/assign_volume", {"volume": 3})  # already exists
    fids = {}
    rng = np.random.default_rng(SEED)
    for i in range(24):
        vid = (3, 4, 5)[i % 3]
        key, cookie = int(rng.integers(1, 1 << 40)), int(
            rng.integers(0, 1 << 32))
        fid = f"{vid},{key:x}{cookie:08x}"
        data = _payload(int(rng.integers(1, 150_000)), i)
        q = f"?ts={TS}"
        if i % 4 == 1:
            q += f"&name=obj{i}.bin&mime=application/x-test"
        if i == 7:
            q += "&ttl=3d"
        col = "c" if vid != 3 else ""
        do("POST", f"/{fid}{q}", data, _auth(fid))
        fids[fid] = (data, col)
    # multipart, gzip, a JPEG (orientation fix) and a PNG (resize)
    mp_fid = "3,0a0b0c0d0e0f1011"
    body = (b"--B1\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"dir/up.txt\"\r\nContent-Type: text/plain\r\n\r\n"
            + _payload(3000, 99) + b"\r\n--B1--\r\n")
    do("POST", f"/{mp_fid}?ts={TS}", body, {
        **_auth(mp_fid), "Content-Type": "multipart/form-data; boundary=B1"})
    import gzip
    gz_fid = "3,1a0b0c0d0e0f1011"
    plain = b"seaweed text " * 500
    do("POST", f"/{gz_fid}?ts={TS}&gzipped=true&mime=text/plain",
       gzip.compress(plain, mtime=0), _auth(gz_fid))
    jpg_fid, png_fid = "4,2a0b0c0d0e0f1011", "4,3a0b0c0d0e0f1011"
    do("POST", f"/{jpg_fid}?ts={TS}", _image("JPEG"),
       {**_auth(jpg_fid), "Content-Type": "image/jpeg"})
    do("POST", f"/{png_fid}?ts={TS}&mime=image/png", _image("PNG"),
       _auth(png_fid))
    # JWT refusals: none, and one minted for another fid
    do("POST", f"/3,4a0b0c0d0e0f1011?ts={TS}", b"x")
    do("POST", f"/3,4a0b0c0d0e0f1011?ts={TS}", b"x", _auth("3,99"))
    do("POST", "/9,4a0b0c0d0e0f1011", b"x", _auth("9,4a0b0c0d0e0f1011"))
    do("POST", "/notafid", b"x")
    # reads
    for fid in list(fids)[:12] + [mp_fid, jpg_fid]:
        do("GET", f"/{fid}")
    do("GET", f"/{gz_fid}")
    do("GET", f"/{gz_fid}", headers={"Accept-Encoding": "gzip"})
    do("HEAD", f"/{list(fids)[0]}")
    do("GET", f"/{png_fid}?width=20&height=12")
    do("GET", f"/{list(fids)[1]}".replace(",", "/", 1))  # /vid/fid form
    first = list(fids)[0]
    do("GET", f"/{first[:-8]}deadbeef")  # cookie mismatch
    do("GET", "/3,ffffff0000000000")
    do("GET", "/77,ffffff0000000000")  # no volume, no master
    # deletes, and batch_delete with and without tokens
    gone = list(fids)[2:5]
    for fid in gone:
        do("DELETE", f"/{fid}", headers=_auth(fid))
        do("GET", f"/{fid}")
    do("DELETE", f"/{list(fids)[5]}")  # no token
    batch = list(fids)[6:8]
    do_json("/admin/batch_delete", {"fids": batch + ["77,0102030405"]},
            _auth(batch[0]))
    for fid in batch:
        do("GET", f"/{fid}")
    # volume admin
    do_json("/admin/readonly", {"volume": 4})
    do("POST", f"/{list(fids)[1]}?ts={TS}", b"late", _auth(list(fids)[1]))
    do_json("/admin/readonly", {"volume": 4, "readonly": False})
    do_json("/admin/vacuum/check", {"volume": 3})
    do_json("/admin/vacuum/compact", {"volume": 3,
                                      "compaction_byte_per_second": 0})
    do_json("/admin/vacuum/commit", {"volume": 3})
    do_json("/admin/vacuum/check", {"volume": 3})
    do_json("/admin/vacuum/check", {"volume": 99})
    do_json("/admin/volume_configure_replication",
            {"volume": 5, "replication": "001"})
    do_json("/admin/volume_unmount", {"volume": 5})
    do_json("/admin/volume_unmount", {"volume": 5})
    do_json("/admin/volume_mount", {"volume": 5, "collection": "c"})
    # a remounted volume reports its .dat's mtime: one for both
    os.utime(os.path.join(root, "c_5.dat"), (1_700_000_000, 1_700_000_000))
    do_json("/admin/volume_mount", {"volume": 55})
    do("GET", "/status")
    do("GET", "/healthz")
    do("GET", "/admin/fault")
    for fid in list(fids)[:12]:
        do("GET", f"/{fid}")
    # EC: generate, mount, drop the volume, read, lose shards, rebuild
    do_json("/admin/readonly", {"volume": 3})
    do_json("/admin/ec/generate", {"volume": 3})
    do_json("/admin/ec/generate", {"volume": 33})
    do_json("/admin/ec/mount", {"volume": 3,
                                "shard_ids": list(range(C.TOTAL_SHARDS))})
    do_json("/admin/delete_volume", {"volume": 3})
    ec_fids = [f for f in fids if f.startswith("3,") and f not in gone
               and f not in batch] + [mp_fid, gz_fid]
    for fid in ec_fids:
        do("GET", f"/{fid}")
    do("GET", "/admin/ec/read?volume=3&shard=2&offset=8&size=4096")
    do("GET", "/admin/ec/read?volume=3&shard=20&offset=0&size=1")
    for ext in (".ec00", ".ecx", ".vif", ".ecj", ".bogus"):
        do("GET", f"/admin/ec/download?volume=3&collection=&ext={ext}")
    do_json("/admin/ec/delete_shards", {"volume": 3,
                                        "shard_ids": [0, 5, 11, 13]})
    for fid in ec_fids:
        do("GET", f"/{fid}")  # reconstructed from the ten left
    do_json("/admin/ec/rebuild", {"volume": 3})
    do_json("/admin/ec/mount", {"volume": 3, "shard_ids": [0, 5, 11, 13]})
    do_json("/admin/ec/unmount", {"volume": 3, "shard_ids": [13]})
    do_json("/admin/ec/mount", {"volume": 3, "shard_ids": [13]})
    do_json("/admin/ec/blob_delete", {"volume": 3,
                                      "needle_id_cookie": ec_fids[0][2:]})
    do("DELETE", f"/{ec_fids[1]}", headers=_auth(ec_fids[1]))
    do_json("/admin/ec/blob_delete", {"volume": 31, "needle_id": 1})
    for fid in ec_fids[:4]:
        do("GET", f"/{fid}")
    do("GET", "/status")
    do_json("/admin/ec/to_volume", {"volume": 3})
    for fid in ec_fids:
        do("GET", f"/{fid}")
    # the batch encode of two volumes of the collection
    do_json("/admin/readonly", {"volume": 4})
    do_json("/admin/readonly", {"volume": 5})
    do_json("/admin/ec/generate_batch", {"volumes": [4, 5],
                                         "collection": "c"})
    do_json("/admin/ec/generate_batch", {"volumes": [4, 66]})
    do_json("/admin/leave", {})
    return out


def _files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """Case (a) on each package, under the same record clock."""
    mp = pytest.MonkeyPatch()
    mp.setattr(time, "time_ns", lambda: STAMP_NS)
    got = {}
    try:
        for name, cls, kw in (
            ("ref", RefVolumeServer, {}),
            ("port", VolumeServer, {"device": "cpu"}),
        ):
            root = tmp_path_factory.mktemp(f"seq_{name}")
            vs = cls(NO_MASTER, [str(root)], jwt_signing_key=KEY,
                     pulse_seconds=60, max_volume_counts=[8], **kw)
            vs.start()
            try:
                steps = _sequence(vs.url, str(root))
            finally:
                vs.stop()
            got[name] = (steps, _files(root))
    finally:
        mp.undo()
    return got


def test_same_statuses_and_bodies(sequences):
    ref, port = sequences["ref"][0], sequences["port"][0]
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"step {i}"
    statuses = {s for s, _, _ in port}
    assert {200, 400, 401, 404, 409, 500} <= statuses


def test_same_files(sequences):
    ref, port = sequences["ref"][1], sequences["port"][1]
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
    # the decoded volume, both batch-encoded volumes' shards and indexes
    assert {"3.dat", "3.idx", "c_4.ec13", "c_5.ecx"} <= set(port)


def test_generate_timing_is_the_phase_waterfall(tmp_path):
    from seaweedfs_tpu_torch.storage import needle, volume

    v = volume.Volume(tmp_path, "", 7)
    for i in range(1, 40):
        v.write_needle(needle.Needle(cookie=i, id=i, data=_payload(5000, i)))
    v.close()
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], device="cpu",
                      pulse_seconds=60)
    vs.start()
    try:
        st, _, body = post_json(vs.url, "/admin/ec/generate", {"volume": 7})
        assert st == 200
        timing = json.loads(body)["timing"]
        assert {"read", "codec", "write", "index"} <= set(timing["phases"])
        assert timing["wall_seconds"] > 0
    finally:
        vs.stop()


def test_server_codecs_take_its_options(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, rebuild

    vs = VolumeServer(NO_MASTER, [str(tmp_path)], device="cpu",
                      device_min_bytes=4321, link_aware=False)
    seen = []

    def spy(fn):
        def wrapped(*a, rs=None, **kw):
            seen.append((rs.device.type, rs.device_min_bytes,
                         rs.link_aware))
            return fn(*a, rs=rs, **kw)
        return wrapped

    monkeypatch.setattr(encoder, "write_ec_files",
                        spy(encoder.write_ec_files))
    monkeypatch.setattr(encoder, "write_ec_files_batch",
                        spy(encoder.write_ec_files_batch))
    monkeypatch.setattr(rebuild, "rebuild_ec_files",
                        spy(rebuild.rebuild_ec_files))
    vs.start()
    try:
        for vid in (1, 2):
            assert post_json(vs.url, "/admin/assign_volume",
                             {"volume": vid})[0] == 200
            call(vs.url, "POST", f"/{vid},0101020304?ts={TS}",
                 _payload(2000, vid))
        assert post_json(vs.url, "/admin/ec/generate", {"volume": 1})[0] \
            == 200
        assert post_json(vs.url, "/admin/ec/generate_batch",
                         {"volumes": [2]})[0] == 200
        os.remove(os.path.join(str(tmp_path), "1.ec04"))
        assert post_json(vs.url, "/admin/ec/rebuild", {"volume": 1})[0] \
            == 200
        post_json(vs.url, "/admin/ec/mount", {"volume": 1,
                                              "shard_ids": [0, 1]})
        ev = vs.store.find_ec_volume(1)
        seen.append((ev.rs.device.type, ev.rs.device_min_bytes,
                     ev.rs.link_aware))
    finally:
        vs.stop()
    assert seen == [("cpu", 4321, False)] * 4


def test_concurrent_degraded_reads(tmp_path):
    """Eight client threads reading one EcVolume with four shards lost:
    the server's shared codec and the volume's lock keep every read
    byte-exact."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch.storage import needle, volume
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    v = volume.Volume(tmp_path, "", 8)
    want = {}
    for i in range(1, 61):
        data = _payload(3000 + 997 * i, 500 + i)
        v.write_needle(needle.Needle(cookie=i, id=i, data=data))
        want[f"8,{i:02x}{i:08x}"] = data
    v.close()
    base = str(tmp_path / "8")
    encoder.write_ec_files(base, device="cpu", batch_bytes=1 << 16)
    encoder.write_sorted_file_from_idx(base)
    for sid in (0, 5, 11, 13):
        os.remove(base + C.to_ext(sid))
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], device="cpu",
                      pulse_seconds=60)
    vs.start()
    try:
        assert vs.store.find_ec_volume(8).shard_ids == [
            i for i in range(C.TOTAL_SHARDS) if i not in (0, 5, 11, 13)]
        fids = list(want) * 3
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(
                lambda f: call(vs.url, "GET", f"/{f}")[::2], fids))
        assert got == [(200, want[f]) for f in fids]
    finally:
        vs.stop()
        port_retry.BREAKERS.reset()


@pytest.mark.skipif("torch.cuda.is_available()")
def test_volume_server_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeServer(NO_MASTER, [str(tmp_path)])


def test_what_waits_answers_501(tmp_path):
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], device="cpu",
                      pulse_seconds=60)
    vs.start()
    ref = RefVolumeServer(NO_MASTER, [str(tmp_path / "ref")],
                          pulse_seconds=60)
    ref.start()
    try:
        # the name is historical: nothing answers 501 any more. The tier
        # routes refuse a request naming no volume, or one the server
        # does not hold, as the reference's do
        for body in (b"{}", b'{"volume": 7}'):
            for path in ("/admin/tier/upload", "/admin/tier/download"):
                got = call(vs.url, "POST", path, body)
                assert got[0] not in (404, 501), path
                assert got[::2] == call(ref.url, "POST", path, body)[::2]
        # fsck, the status page and the query now answer, and the tail
        # of a volume the server does not hold fails as the reference's
        # does
        assert call(vs.url, "POST", "/admin/query", b"{}")[0] == 200
        assert call(vs.url, "POST", "/admin/fsck", b"{}")[0] == 200
        assert call(vs.url, "GET", "/ui")[0] == 200
        assert call(vs.url, "GET", "/admin/tail?volume=1")[0] == 500
        post_json(vs.url, "/admin/assign_volume", {"volume": 1})
        manifest = json.dumps({"chunks": [{"fid": "1,02", "offset": 0}],
                               "size": 3}).encode()
        assert call(vs.url, "POST", "/1,0101020304?cm=true",
                    manifest)[0] == 200
        # the raw manifest only when asked for, as the reference does; a
        # raw delete removes the manifest and fans out to no chunk
        assert call(vs.url, "GET", "/1,0101020304?cm=false")[2] == manifest
        assert call(vs.url, "GET", "/1,0101020304?cm=false")[0] == 200
        assert call(vs.url, "DELETE", "/1,0101020304?cm=false")[0] == 200
    finally:
        vs.stop()
        ref.stop()


def _copy_run(src_cls, dst_cls, root):
    """One volume of seeded needles on a source server, pulled whole by
    a target over ``/admin/volume_copy``: the copy's status and body, a
    second copy's (409), a read through the target, and the files."""
    servers = []
    for name, cls in (("src", src_cls), ("dst", dst_cls)):
        kw = {"device": "cpu"} if cls is VolumeServer else {}
        os.makedirs(os.path.join(root, name))
        servers.append(cls(NO_MASTER, [os.path.join(root, name)],
                           pulse_seconds=60, max_volume_counts=[4], **kw))
        servers[-1].start()
    src, dst = servers
    try:
        post_json(src.url, "/admin/assign_volume",
                  {"volume": 3, "collection": "c"})
        fids = [f"3,{i + 1:x}{0x1234abcd + i:08x}" for i in range(12)]
        for i, fid in enumerate(fids):
            assert call(src.url, "POST", f"/{fid}?ts={TS}",
                        _payload(100 + 997 * i, i))[0] == 200
        assert call(src.url, "DELETE", f"/{fids[0]}")[0] == 200
        body = {"volume": 3, "collection": "c", "source": src.url}
        out = [post_json(dst.url, "/admin/volume_copy", body),
               post_json(dst.url, "/admin/volume_copy", body)]
        out.append(call(dst.url, "GET", f"/{fids[5]}")[::2])
        files = {}
        for name, vs in (("src", src), ("dst", dst)):
            for ext in (".dat", ".idx"):
                files[name, ext] = call(
                    vs.url, "GET", "/admin/ec/download?volume=3"
                    f"&collection=c&ext={ext}")[2]
        return out, files
    finally:
        for vs in servers:
            vs.stop()
        port_retry.BREAKERS.reset()


@pytest.mark.parametrize("src,dst", [("port", "port"), ("ref", "port"),
                                     ("port", "ref")])
def test_volume_copy_matches_reference(tmp_path, monkeypatch, src, dst):
    """``/admin/volume_copy`` between port servers, and each way between
    a port and a reference server, answers as two reference servers do
    and leaves the target the source's ``.dat`` and ``.idx``."""
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    cls = {"port": VolumeServer, "ref": RefVolumeServer}
    want, want_files = _copy_run(RefVolumeServer, RefVolumeServer,
                                 str(tmp_path / "ref"))
    got, files = _copy_run(cls[src], cls[dst], str(tmp_path / "got"))
    assert got == want
    assert (want[0][0], want[0][2]) == (200, b'{"ok": true}')
    assert want[1][0] == 409
    assert want[2] == (200, _payload(100 + 997 * 5, 5))
    assert files == want_files
    for ext in (".dat", ".idx"):
        assert files["dst", ext] == files["src", ext]
        assert len(files["dst", ext]) > 8


def test_metrics_count_the_requests(tmp_path, monkeypatch):
    monkeypatch.setattr(port_stats, "VOLUME_SERVER_REQUESTS",
                        port_stats.Counter("t_req", "", ("type",)))
    monkeypatch.setattr(port_stats, "VOLUME_SERVER_LATENCY",
                        port_stats.Histogram("t_lat", "", ("type",)))
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], device="cpu",
                      pulse_seconds=60)
    vs.start()
    try:
        post_json(vs.url, "/admin/assign_volume", {"volume": 1})
        for i in range(5):
            call(vs.url, "POST", f"/1,0{i + 1}01020304", b"x" * i)
        for i in range(3):
            call(vs.url, "GET", f"/1,0{i + 1}01020304")
        text = call(vs.url, "GET", "/metrics")[2].decode()
    finally:
        vs.stop()
    assert port_stats.VOLUME_SERVER_REQUESTS.values() == {
        ("post",): 5.0, ("get",): 3.0}
    assert {k: v[1] for k, v in
            port_stats.VOLUME_SERVER_LATENCY.snapshot().items()} == {
        ("post",): 5, ("get",): 3}
    for family in ("SeaweedFS_volumeServer_request_total",
                   "SeaweedFS_volumeServer_request_seconds",
                   "SeaweedFS_volumeServer_volumes",
                   "seaweedfs_codec_route_total"):
        assert f"# TYPE {family} " in text


# -- (b) the mixed cluster -----------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ.setdefault("SEAWEEDFS_FAULTS_ADMIN", "1")
    root = tmp_path_factory.mktemp("mixed")
    master = MasterServer(pulse_seconds=0.2)
    master.start()
    servers = []
    try:
        for i in range(4):
            vs = VolumeServer(
                master.url, [str(root / f"vs{i}")], max_volume_counts=[10],
                data_center="dc1", rack=f"rack{i % 2}", pulse_seconds=0.2,
                device="cpu",
            )
            vs.start()
            servers.append(vs)
        deadline = time.time() + 10
        while len(master.topo.data_nodes()) < 4:
            assert time.time() < deadline, "port servers did not register"
            time.sleep(0.05)
        env = CommandEnv(master.url)
        env.lock()
        yield master, servers, env, root
        env.unlock()
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        port_retry.BREAKERS.reset()
        shutil.rmtree(root, ignore_errors=True)


def _settle(pulses=3):
    time.sleep(0.2 * pulses)


def test_mixed_cluster_ec_workflow(cluster, tmp_path):
    master, servers, env, _ = cluster
    m = master.url
    urls = {vs.url for vs in servers}
    files = {}
    for i in range(24):
        data = _payload(500 + (i * 7919) % 4096, 1000 + i)
        fid, _ = operation.upload_data(m, data)
        files[fid] = data
    vid = sorted({int(fid.split(",")[0]) for fid in files})[0]
    subset = {f: d for f, d in files.items() if int(f.split(",")[0]) == vid}
    assert subset
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid
    # the volume as it stands, for the reference encoder
    holder = ref_http.get_json(f"{m}/dir/lookup?volumeId={vid}")[
        "locations"][0]["url"]
    assert holder in urls
    ref_base = str(tmp_path / str(vid))
    for ext in (".dat", ".idx"):
        with open(ref_base + ext, "wb") as f:
            f.write(ref_http.request(
                "GET", f"http://{holder}/admin/ec/download?volume={vid}"
                f"&collection=&ext={ext}"))
    ref_encoder.write_ec_files(ref_base)
    ref_encoder.write_sorted_file_from_idx(ref_base)

    # reads during the encode: each one that answers is byte-exact
    stop, seen, wrong = threading.Event(), [0], []

    def reader():
        while not stop.is_set():
            for fid, data in subset.items():
                try:
                    got = operation.read_file(m, fid)
                except Exception:  # noqa: BLE001 - a miss is not a wrong byte
                    continue
                seen[0] += 1
                if got != data:
                    wrong.append(fid)

    t = threading.Thread(target=reader)
    t.start()
    try:
        out = run_command(env, f"ec.encode -volumeId {vid}")
    finally:
        stop.set()
        t.join()
    assert f"volume {vid}: ec.encode done" in out
    assert seen[0] > 0 and not wrong
    _settle()
    shard_info = ref_http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    assert {int(s) for s in shard_info["shards"]} == set(
        range(C.TOTAL_SHARDS))
    holders = {loc["url"] for locs in shard_info["shards"].values()
               for loc in locs}
    assert holders <= urls and len(holders) >= 2
    # every shard on the port servers equals the reference encoder's
    for sid, locs in shard_info["shards"].items():
        ext = C.to_ext(int(sid))
        with open(ref_base + ext, "rb") as f:
            want = f.read()
        for loc in locs:
            assert ref_http.request(
                "GET", f"http://{loc['url']}/admin/ec/download?volume="
                f"{vid}&collection=&ext={ext}") == want, (sid, loc)
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid

    # lose two shards, rebuild through the shell
    kill = []
    for sid_str, locs in sorted(shard_info["shards"].items())[:2]:
        ref_http.post_json(f"{locs[0]['url']}/admin/ec/delete_shards",
                           {"volume": vid, "shard_ids": [int(sid_str)]})
        kill.append(int(sid_str))
    _settle(5)
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid
    out = run_command(env, f"ec.rebuild -volumeId {vid}")
    assert "rebuilt shards" in out
    _settle(5)
    shard_info = ref_http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    assert {int(s) for s in shard_info["shards"]} == set(
        range(C.TOTAL_SHARDS))
    for sid in kill:
        with open(ref_base + C.to_ext(sid), "rb") as f:
            want = f.read()
        loc = shard_info["shards"][str(sid)][0]["url"]
        assert ref_http.request(
            "GET", f"http://{loc}/admin/ec/download?volume={vid}"
            f"&collection=&ext={C.to_ext(sid)}") == want
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid

    # back to a normal volume
    out = run_command(env, f"ec.decode -volumeId {vid}")
    assert "decoded back to normal volume" in out
    _settle(5)
    with pytest.raises(ref_http.HttpError):
        ref_http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid


def test_mixed_cluster_parallel_batch_encode(cluster):
    """The reference shell's ``ec.encode -parallel``: volumes grouped by
    source server and encoded in one ``/admin/ec/generate_batch`` on a
    port server; every file reads back afterwards."""
    from seaweedfs_tpu.shell.command_ec import do_ec_encode_parallel

    master, _, env, _ = cluster
    files = {}
    for i in range(24):
        data = _payload(300 + (i * 131) % 2048, 3000 + i)
        fid, _ = operation.upload_data(master.url, data, collection="parP")
        files[fid] = data
    vids = sorted({int(fid.split(",")[0]) for fid in files})
    assert len(vids) >= 2
    out = io.StringIO()
    do_ec_encode_parallel(env, "parP", vids, out)
    log = out.getvalue()
    assert "batch-generated shards on" in log
    for vid in vids:
        assert f"volume {vid}: ec.encode done" in log
    _settle()
    for fid, data in files.items():
        assert operation.read_file(master.url, fid) == data, fid


def test_mixed_cluster_replicated_write(cluster):
    master, servers, _, _ = cluster
    m = master.url
    data = _payload(12_345, 77)
    fid, _ = operation.upload_data(m, data, replication="001")
    vid = fid.split(",")[0]
    locs = ref_http.get_json(f"{m}/dir/lookup?volumeId={vid}")["locations"]
    assert len(locs) == 2
    assert {loc["url"] for loc in locs} <= {vs.url for vs in servers}
    for loc in locs:
        st, _, body = call(loc["url"], "GET", f"/{fid}")
        assert (st, body) == (200, data), loc
    # a replicated delete reaches both too
    operation.delete_file(m, fid)
    for loc in locs:
        assert call(loc["url"], "GET", f"/{fid}")[0] == 404, loc
