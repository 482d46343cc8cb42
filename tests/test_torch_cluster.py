"""Whole port clusters (``server/harness.py``, ``operation/``, ``shell/``,
``maintenance/ops.py``) held against the reference on the CPU.

(a) The harness cases of ``tests/test_cluster.py`` on a port
    ``ClusterHarness(device="cpu")`` through the port's ``operation``
    client (its other three cases are in ``test_torch_master.py``), and
    ``tests/test_cli.py``'s auto-split upload, a chunk manifest the port
    server resolves.
(b) The cases of ``tests/test_ec_workflow.py`` that use only ported
    commands, through the port's shell on a port cluster.
(c) One EC workflow — a volume of seeded needles written under one
    pinned record clock, ``ec.encode``, degraded reads with four shards
    lost, ``ec.rebuild``, ``ec.decode`` — run by each shell on each
    cluster: the port's shell on a reference cluster, the reference's
    shell on a port cluster, and the port's shell on a port cluster,
    each held to the reference's shell on a reference cluster. Every
    shard, rebuilt shard and decoded ``.dat``/``.idx`` is byte-equal
    (the decoded ``.dat`` is the volume's live extent, its ``.idx`` the
    ``.ecx``), every read byte-exact, and the shell output the same once
    server URLs are named by role and the measured phase lines are
    dropped.
"""

import hashlib
import http.client as http_client
import io
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.server import harness as ref_harness  # noqa: E402
from seaweedfs_tpu.shell import (  # noqa: E402
    CommandEnv as RefCommandEnv,
    run_command as ref_run_command,
)
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation  # noqa: E402
from seaweedfs_tpu_torch.operation import client as op_client  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.shell import CommandEnv, run_command  # noqa: E402
from seaweedfs_tpu_torch.shell.command_ec import (  # noqa: E402
    do_ec_encode_parallel,
)
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
)
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SEED = 9
STAMP_NS = 1_700_000_000_123_456_789
TS = "1700000000"


def _reset_client_state():
    op_client._lookup_cache.clear()
    port_retry.BREAKERS.reset()


# -- (a) the harness cases of tests/test_cluster.py ---------------------------


@pytest.fixture(scope="module")
def cluster():
    with ClusterHarness(n_volume_servers=3, volumes_per_server=20,
                        device="cpu") as c:
        c.wait_for_nodes(3)
        yield c
    _reset_client_state()


def test_assign_upload_read_delete(cluster):
    m = cluster.master.url
    fid, size = operation.upload_data(m, b"hello seaweed", name="x.txt")
    assert size == 13
    assert operation.read_file(m, fid) == b"hello seaweed"
    operation.delete_file(m, fid)
    with pytest.raises(FileNotFoundError):
        operation.read_file(m, fid)


def test_many_files_roundtrip(cluster):
    m = cluster.master.url
    files = {}
    for i in range(40):
        data = f"content-{i}".encode() * (i + 1)
        fid, _ = operation.upload_data(m, data)
        files[fid] = data
    for fid, data in files.items():
        assert operation.read_file(m, fid) == data


def test_replicated_write_and_delete(cluster):
    m = cluster.master.url
    fid, _ = operation.upload_data(m, b"replicated!", replication="001")
    locations = operation.lookup(m, fid, refresh=True)
    assert len(locations) == 2
    for loc in locations:
        assert http.request("GET", f"{loc['url']}/{fid}") == b"replicated!"
    operation.delete_file(m, fid)
    for loc in locations:
        with pytest.raises(http.HttpError):
            http.request("GET", f"{loc['url']}/{fid}")


def test_read_redirect_from_wrong_server(cluster):
    m = cluster.master.url
    fid, _ = operation.upload_data(m, b"redirect me")
    holder_urls = {loc["url"] for loc in operation.lookup(m, fid,
                                                          refresh=True)}
    other = next(vs.url for vs in cluster.volume_servers
                 if vs.url not in holder_urls)
    assert http.request("GET", f"{other}/{fid}") == b"redirect me"


def test_vacuum_orchestration(cluster):
    m = cluster.master.url
    fids = [operation.upload_data(m, b"x" * 2000, collection="vac")[0]
            for _ in range(20)]
    for fid in fids[:15]:
        operation.delete_file(m, fid)
    out = http.post_json(f"{m}/vol/vacuum?garbageThreshold=0.3", {})
    assert out["vacuumed"], "expected at least one volume vacuumed"
    for fid in fids[15:]:
        assert operation.read_file(m, fid) == b"x" * 2000
    for fid in fids[:15]:
        with pytest.raises(FileNotFoundError):
            operation.read_file(m, fid)


def test_node_death_unregisters(cluster):
    cluster.wait_for_nodes(3)
    cluster.kill_volume_server(2)
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(cluster.master.topo.data_nodes()) == 2:
            break
        time.sleep(0.1)
    assert len(cluster.master.topo.data_nodes()) == 2
    cluster.restart_volume_server(2)
    cluster.wait_for_nodes(3)


def test_batch_delete(cluster):
    m = cluster.master.url
    fids = [operation.upload_data(m, b"bd")[0] for _ in range(3)]
    by_server: dict[str, list[str]] = {}
    for fid in fids:
        loc = operation.lookup(m, fid, refresh=True)[0]
        by_server.setdefault(loc["url"], []).append(fid)
    for url, batch in by_server.items():
        out = http.post_json(f"{url}/admin/batch_delete", {"fids": batch})
        assert all(r["status"] == 200 for r in out["results"])


def test_multipart_form_upload(cluster):
    a = http.get_json(f"{cluster.master.url}/dir/assign")
    boundary = "----testboundary42"
    payload = b"hello multipart world"
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; '
        f'filename="greet.txt"\r\n'
        f"Content-Type: text/plain\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    out = http.request(
        "POST", f"{a['url']}/{a['fid']}", body,
        {"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    assert json.loads(out)["size"] == len(payload)
    assert http.request("GET", f"{a['url']}/{a['fid']}") == payload


def test_parse_multipart_unit():
    body = (
        b"--xyz\r\n"
        b'Content-Disposition: form-data; name="a"\r\n\r\n'
        b"value-a\r\n"
        b"--xyz\r\n"
        b'Content-Disposition: form-data; name="f"; filename="x.bin"\r\n'
        b"Content-Type: application/json\r\n\r\n"
        b'{"k": 1}\r\n'
        b"--xyz--\r\n"
    )
    parts = http.parse_multipart(body, 'multipart/form-data; boundary="xyz"')
    assert len(parts) == 2
    assert parts[0].name == "a" and parts[0].data == b"value-a"
    assert parts[0].filename is None
    assert parts[1].filename == "x.bin"
    assert parts[1].mime == "application/json"
    assert parts[1].data == b'{"k": 1}'


def test_upload_auto_split_manifest(tmp_path):
    """``tests/test_cli.py``'s auto-split case on a port cluster: the
    port's ``submit_file`` past ``max_mb`` stores a chunk manifest, the
    port server resolves it into one body, serves it raw on ``cm=false``
    and fans a delete out to its chunks."""
    rng = np.random.default_rng(13)
    blob = rng.integers(0, 256, size=10 * 1024 * 1024,
                        dtype=np.uint8).tobytes()
    src = tmp_path / "big.bin"
    src.write_bytes(blob)
    with ClusterHarness(n_volume_servers=2, volumes_per_server=10,
                        root=str(tmp_path / "c"), device="cpu") as c:
        c.wait_for_nodes(2)
        fid, size = operation.submit_file(c.master.url, str(src), max_mb=2)
        assert size == len(blob)
        assert operation.read_file(c.master.url, fid) == blob
        locs = operation.lookup(c.master.url, fid)
        manifest = json.loads(http.request(
            "GET", f"{locs[0]['url']}/{fid}?cm=false"))
        assert len(manifest["chunks"]) == 5
        assert manifest["size"] == len(blob)
        http.request("DELETE", f"{locs[0]['url']}/{fid}")
        for ch in manifest["chunks"]:
            with pytest.raises((FileNotFoundError, http.HttpError)):
                operation.read_file(c.master.url, ch["fid"])
    _reset_client_state()


# -- (b) the cases of tests/test_ec_workflow.py with ported commands ----------

RNG = np.random.default_rng(SEED)


@pytest.fixture(scope="module")
def ec_cluster():
    with ClusterHarness(n_volume_servers=4, volumes_per_server=10,
                        device="cpu") as c:
        c.wait_for_nodes(4)
        yield c
    _reset_client_state()


@pytest.fixture(scope="module")
def env(ec_cluster):
    e = CommandEnv(ec_cluster.master.url)
    e.lock()
    yield e
    e.unlock()


def _upload_corpus(master_url, n=25, collection=""):
    files = {}
    for i in range(n):
        data = RNG.integers(0, 256, size=500 + (i * 7919) % 4096,
                            dtype=np.uint8).tobytes()
        fid, _ = operation.upload_data(master_url, data,
                                       collection=collection)
        files[fid] = data
    return files


def _vid_of(files):
    return sorted({int(fid.split(",")[0]) for fid in files})[0]


def test_ec_encode_rebuild_decode_workflow(ec_cluster, env):
    m = ec_cluster.master.url
    files = _upload_corpus(m, 30)
    vid = _vid_of(files)
    subset = {f: d for f, d in files.items() if int(f.split(",")[0]) == vid}
    assert subset
    out = run_command(env, f"ec.encode -volumeId {vid}")
    assert f"volume {vid}: ec.encode done" in out
    ec_cluster.settle()
    shard_info = http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    assert {int(s) for s in shard_info["shards"]} == set(
        range(C.TOTAL_SHARDS))
    assert len({loc["url"] for locs in shard_info["shards"].values()
                for loc in locs}) >= 2, "shards must be spread"
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid
    kill = []
    for sid_str, locs in shard_info["shards"].items():
        if len(kill) >= 2:
            break
        http.post_json(f"{locs[0]['url']}/admin/ec/delete_shards",
                       {"volume": vid, "shard_ids": [int(sid_str)]})
        kill.append(int(sid_str))
    ec_cluster.settle(5)
    out = run_command(env, f"ec.rebuild -volumeId {vid}")
    assert "rebuilt shards" in out
    ec_cluster.settle(5)
    shard_info = http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    assert {int(s) for s in shard_info["shards"]} == set(
        range(C.TOTAL_SHARDS))
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid
    out = run_command(env, f"ec.decode -volumeId {vid}")
    assert "decoded back to normal volume" in out
    ec_cluster.settle(5)
    with pytest.raises(http.HttpError):
        http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid


def test_ec_read_with_missing_shard_reconstruction(ec_cluster, env):
    m = ec_cluster.master.url
    files = _upload_corpus(m, 20, collection="recon")
    vid = _vid_of(files)
    subset = {f: d for f, d in files.items() if int(f.split(",")[0]) == vid}
    run_command(env, f"ec.encode -volumeId {vid} -collection recon")
    ec_cluster.settle(5)
    shard_info = http.get_json(f"{m}/ec/lookup?volumeId={vid}")
    for loc in shard_info["shards"]["0"]:
        http.post_json(f"{loc['url']}/admin/ec/delete_shards",
                       {"volume": vid, "collection": "recon",
                        "shard_ids": [0]})
    ec_cluster.settle(5)
    for fid, data in subset.items():
        assert operation.read_file(m, fid) == data, fid


def test_shell_requires_lock(ec_cluster):
    env2 = CommandEnv(ec_cluster.master.url)
    with pytest.raises(RuntimeError, match="lock"):
        run_command(env2, "ec.encode -volumeId 999")


def test_ec_encode_parallel_batch(ec_cluster, env):
    files = _upload_corpus(ec_cluster.master.url, n=24, collection="parP")
    vids = sorted({int(fid.split(",")[0]) for fid in files})
    assert len(vids) >= 2
    out = io.StringIO()
    do_ec_encode_parallel(env, "parP", vids, out)
    log = out.getvalue()
    assert "batch-generated shards on" in log
    for vid in vids:
        assert f"volume {vid}: ec.encode done" in log
    ec_cluster.settle()
    for fid, data in files.items():
        assert operation.read_file(ec_cluster.master.url, fid) == data


# -- (c) each shell on each cluster -----------------------------------------

CLUSTERS = {
    "port": lambda: ClusterHarness(n_volume_servers=4, volumes_per_server=10,
                                   device="cpu"),
    "ref": lambda: ref_harness.ClusterHarness(n_volume_servers=4,
                                              volumes_per_server=10),
}
SHELLS = {
    "port": types.SimpleNamespace(Env=CommandEnv, run=run_command,
                                  op=operation),
    "ref": types.SimpleNamespace(Env=RefCommandEnv, run=ref_run_command,
                                 op=ref_operation),
}
LOST = [0, 5, 11, 13]


def _call(url, method, path, body=None):
    conn = http_client.HTTPConnection(url.split("//")[-1], timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        data = r.read()
        assert r.status < 300, (method, path, r.status, data)
        return data
    finally:
        conn.close()


def _get_json(url, path):
    return json.loads(_call(url, "GET", path))


def _post_json(url, path, obj):
    return json.loads(_call(url, "POST", path, json.dumps(obj).encode()))


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _wait_shards(m, vid, want: set, timeout=10.0):
    deadline = time.time() + timeout
    while True:
        try:
            have = {int(s) for s in
                    _get_json(m, f"/ec/lookup?volumeId={vid}")["shards"]}
        except AssertionError:
            have = set()
        if have == want:
            return
        assert time.time() < deadline, (sorted(have), sorted(want))
        time.sleep(0.05)


def _shard_files(m, vid, sids):
    """sid -> the set of hashes of that shard wherever it is held, and
    the ``.ecx`` hashes of every holder."""
    info = _get_json(m, f"/ec/lookup?volumeId={vid}")["shards"]
    shards, ecx = {}, set()
    for sid in sids:
        shards[sid] = set()
        for loc in info[str(sid)]:
            u = loc["url"]
            q = f"/admin/ec/download?volume={vid}&collection=&ext="
            shards[sid].add(_sha(_call(u, "GET", q + C.to_ext(sid))))
            ecx.add(_sha(_call(u, "GET", q + ".ecx")))
    return shards, ecx


def _normalise_output(text: str, urls) -> list:
    lines = []
    for line in text.splitlines():
        if ": phases " in line:
            continue  # the measured phase waterfall
        for u in urls:
            line = line.replace(u, "<vs>")
        lines.append(line)
    return sorted(lines)


def _ec_run(cluster_kind, shell_kind, monkeypatch) -> dict:
    sh = SHELLS[shell_kind]
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    c = CLUSTERS[cluster_kind]()
    obs = {"out": []}
    try:
        c.wait_for_nodes(4)
        m = c.master.url
        urls = sorted(vs.url for vs in c.volume_servers)
        # one volume, seeded needles at fixed fids, one record clock
        assert _get_json(m, "/vol/grow?count=1") == {"count": 1}
        holder = _get_json(m, "/dir/lookup?volumeId=1")["locations"][0]["url"]
        rng = np.random.default_rng(SEED)
        files = {}
        for i in range(40):
            fid = f"1,{i + 1:x}{int(rng.integers(0, 1 << 32)):08x}"
            data = rng.integers(0, 256, int(rng.integers(1, 6000)),
                                dtype=np.uint8).tobytes()
            _call(holder, "POST", f"/{fid}?ts={TS}", data)
            files[fid] = data
        _call(holder, "DELETE", f"/{next(iter(files))}")
        files.pop(next(iter(files)))
        q = "/admin/ec/download?volume=1&collection=&ext="
        dat = _call(holder, "GET", q + ".dat")
        obs["dat"] = _sha(dat)
        obs["idx"] = _sha(_call(holder, "GET", q + ".idx"))

        def read_all():
            for fid, data in files.items():
                assert sh.op.read_file(m, fid) == data, fid

        env = sh.Env(m)
        obs["out"].append(sh.run(env, "lock"))
        obs["out"].append(sh.run(env, "ec.encode -volumeId 1"))
        _wait_shards(m, 1, set(range(C.TOTAL_SHARDS)))
        obs["shards"], obs["ecx"] = _shard_files(m, 1,
                                                 range(C.TOTAL_SHARDS))
        read_all()
        info = _get_json(m, "/ec/lookup?volumeId=1")["shards"]
        for sid in LOST:
            for loc in info[str(sid)]:
                _post_json(loc["url"], "/admin/ec/delete_shards",
                           {"volume": 1, "shard_ids": [sid]})
        _wait_shards(m, 1, set(range(C.TOTAL_SHARDS)) - set(LOST))
        read_all()  # degraded: four shards lost
        obs["out"].append(sh.run(env, "ec.rebuild -volumeId 1"))
        _wait_shards(m, 1, set(range(C.TOTAL_SHARDS)))
        obs["rebuilt"], _ = _shard_files(m, 1, LOST)
        read_all()
        obs["out"].append(sh.run(env, "ec.decode -volumeId 1"))
        deadline = time.time() + 10
        while True:
            locs = _get_json(m, "/dir/lookup?volumeId=1")["locations"]
            if len(locs) == 1:
                break
            assert time.time() < deadline, locs
            time.sleep(0.05)
        decoded = _call(locs[0]["url"], "GET", q + ".dat")
        # the live extent of the volume, and its sorted index
        assert decoded == dat[:len(decoded)] and len(decoded) > 8
        obs["decoded"] = [_sha(decoded),
                          _sha(_call(locs[0]["url"], "GET", q + ".idx"))]
        assert obs["decoded"][1] in obs["ecx"]
        read_all()
        obs["out"].append(sh.run(env, "unlock"))
        obs["out"] = _normalise_output("\n".join(obs["out"]), urls)
        return obs
    finally:
        c.stop()
        _reset_client_state()
        ref_retry.BREAKERS.reset()
        ref_operation.client._lookup_cache.clear()


@pytest.fixture(scope="module")
def reference_run():
    mp = pytest.MonkeyPatch()
    try:
        yield _ec_run("ref", "ref", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("cluster_kind,shell_kind", [
    ("ref", "port"), ("port", "ref"), ("port", "port")],
    ids=["port-shell-on-ref-cluster", "ref-shell-on-port-cluster",
         "port-shell-on-port-cluster"])
def test_ec_workflow_matches_reference(reference_run, cluster_kind,
                                       shell_kind, monkeypatch):
    got = _ec_run(cluster_kind, shell_kind, monkeypatch)
    want = reference_run
    # one file per shard, each the reference's, and the same .ecx on
    # every holder
    assert all(len(h) == 1 for h in want["shards"].values())
    assert got["shards"] == want["shards"]
    assert got["ecx"] == want["ecx"] and len(want["ecx"]) == 1
    assert got["rebuilt"] == {s: want["shards"][s] for s in LOST}
    assert got["rebuilt"] == want["rebuilt"]
    assert got["decoded"] == want["decoded"]
    assert (got["dat"], got["idx"]) == (want["dat"], want["idx"])
    assert got["out"] == want["out"]
    assert "volume 1: ec.encode done" in got["out"]
    assert "volume 1: rebuilt shards [0, 5, 11, 13] on <vs>" in got["out"]
    assert "volume 1: shards [0, 4, 8, 12] -> <vs>" in got["out"]
