"""The port's sharded filer tier (``filer/sharding/``) held against the
reference's on the CPU.

Pure routing first: ``routing_key`` and ``ShardMap`` placement on 10,000
seeded paths for N = 1–8, fan-out roots, count drift, the spec's ``f``
suffix and ``benchgate``'s flattening of a round's filer section. Then
one live two-shard tier of each package (the port's over
``device="cpu"`` volume servers), written through its own ``FilerRing``:
each shard holds exactly the paths its map assigns, the fan-out listing
is sorted and complete at every page size, a recursive delete of a
fan-out root reaches every shard, and a cross-shard rename moves the
data. Kill recovery and the shard telemetry that reaches the master read
process-wide counters, so each package runs them in a fresh interpreter
(``tests/_torch_filer_shard_child.py``). Last, the metadata bench runs
its port shards from its embedded script.

Bucket names are chosen for their crc32 homes on a two-shard map:
``alpha``/``echo`` hash to shard 0, ``bravo``/``charlie`` to shard 1.
"""

import json
import os
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.filer.sharding import ring as ref_ring  # noqa: E402
from seaweedfs_tpu.scale import spec as ref_spec  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.util import benchgate as ref_bg  # noqa: E402
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.filer.sharding import ring as port_ring  # noqa: E402
from seaweedfs_tpu_torch.scale import spec as port_spec  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.util import benchgate as port_bg  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = ("alpha", "bravo", "charlie", "echo")


def _paths(seed, n):
    rng = random.Random(seed)
    tops = ["buckets"] * 4 + ["topics", "home", "a", "etc", "x y", "%zz",
                              "ünï", "\U0001F600"]
    out = ["/", "/buckets", "/buckets/", "", "//", "/buckets//b/c"]
    for _ in range(n - len(out)):
        depth = rng.randint(1, 5)
        parts = [rng.choice(tops)] + [
            f"{rng.choice('abcdefgh')}{rng.randint(0, 999)}"
            for _ in range(depth)]
        out.append("/" + "/".join(parts) + ("/" if rng.random() < 0.1
                                            else ""))
    return out


def test_routing_key_equal():
    for p in _paths(1, 2000):
        assert port_ring.routing_key(p) == ref_ring.routing_key(p), p


@pytest.mark.parametrize("n", range(1, 9))
def test_shard_map_equal(n):
    urls = [f"127.0.0.1:{8100 + i}" for i in range(n)]
    port, ref = port_ring.ShardMap(urls), ref_ring.ShardMap(urls)
    paths = _paths(n, 10_000)
    assert [port.shard_of(p) for p in paths] == [
        ref.shard_of(p) for p in paths]
    assert [port.url_for(p) for p in paths[:500]] == [
        ref.url_for(p) for p in paths[:500]]
    dirs = ["/", "/buckets", "/buckets/alpha", "/topics", "/a/b"]
    assert [port.fans_out(d) for d in dirs] == [ref.fans_out(d)
                                                for d in dirs]
    assert len(port) == len(ref) == n
    assert len({port.shard_of(p) for p in paths}) == n


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:
        return (type(e).__name__, str(e))


def test_count_drift_and_bounds_equal():
    for urls in ([], [f"127.0.0.1:{8000 + i}" for i in range(65)],
                 "127.0.0.1:81", ["127.0.0.1:81"] * 2):
        got = _outcome(lambda u=urls: len(port_ring.ShardMap(u)))
        assert got == _outcome(lambda u=urls: len(ref_ring.ShardMap(u)))
    urls = ["127.0.0.1:81", "127.0.0.1:82"]
    for mod in (port_ring, ref_ring):
        ring = mod.FilerRing(urls, masters=None)
        assert ring.reresolve() is False
    assert [port_ring.FilerRing._tombstone_path(p) for p in _paths(3, 50)] \
        == [ref_ring.FilerRing._tombstone_path(p) for p in _paths(3, 50)]
    assert port_ring.primary_url(urls) == ref_ring.primary_url(urls)


def test_spec_filer_suffix_equal():
    for text in ("5x4x5m3f4", "2x1x2f2", "2x1x2", "1x1x1f64", "1x1x1f-1",
                 "5x4x5m3f2"):
        got = _outcome(lambda t=text: str(port_spec.TopologySpec.parse(t)))
        assert got == _outcome(
            lambda t=text: str(ref_spec.TopologySpec.parse(t))), text


def test_benchgate_flattens_filer_section_equal():
    detail = {"filer": {
        "shard_count": 2, "meta_ops_s": 840.5, "shard_speedup": 1.7,
        "shards": {"shard0": {"ops_s": 420.0, "p99_s": 0.002,
                              "error_rate": 0.0},
                   "shard1": {"ops_s": 0.5, "p99_s": 0.9,
                              "error_rate": 0.2, "junk": "x"},
                   "shard2": "not a section"}}}
    for d in (detail, {"filer": None}, {"filer": []}, {}):
        got, want = {}, {}
        port_bg._flatten_filer(d, got)
        ref_bg._flatten_filer(d, want)
        assert got == want
    result = {"benchmark": "scale_churn", "value": 3.0, "detail": detail}
    flat = port_bg.flatten_scale(result)
    assert flat == ref_bg.flatten_scale(result)
    assert "filer.meta_ops_s" in flat and "filer.shard_count" not in flat


# -- one live two-shard tier of each package -----------------------------------


def _tier_run(which, root):
    harness, http, op_mod, retry, kw = {
        "ref": (RefClusterHarness, ref_http, ref_operation, ref_retry, {}),
        "port": (ClusterHarness, port_http, port_operation, port_retry,
                 {"device": "cpu"}),
    }[which]
    op_mod.client._lookup_cache.clear()
    retry.BREAKERS.reset()
    obs = {}
    with harness(n_volume_servers=2, volumes_per_server=20,
                 n_filer_shards=2, telemetry_interval=0, root=root,
                 **kw) as c:
        c.wait_for_nodes(2)
        ring = c.filer_ring()
        obs["homes"] = [ring.shard_of(f"/buckets/{b}") for b in BUCKETS]
        written = []
        for b in BUCKETS:
            ring.request("POST", f"/buckets/{b}/", b"")
            written.append(f"/buckets/{b}")
            for i in range(6):
                p = f"/buckets/{b}/o{i}.txt"
                ring.request("POST", p, f"{b}-{i}".encode() * (i + 1))
                written.append(p)
        for top in ("topics", "home", "logs"):
            ring.request("POST", f"/{top}/f.txt", top.encode())
            written += [f"/{top}", f"/{top}/f.txt"]
        # every shard holds exactly the paths the map gives it
        held = []
        for base in ring.urls:
            mine = []
            for p in written:
                try:
                    http.request("GET", f"{base}{p}?meta=true")
                    mine.append(p)
                except http.HttpError as e:
                    assert e.status == 404
            held.append(mine)
        obs["held"] = held
        obs["assigned"] = [[p for p in written if ring.shard_of(p) == i]
                           for i in range(2)]
        names = [e["FullPath"] for e in ring.list_all("/buckets")]
        obs["list_all"] = names
        obs["list_root"] = [e["FullPath"] for e in ring.list_all("/")]
        pages = {}
        for limit in (1, 2, 3):
            paged, last = [], ""
            while True:
                page = ring.list_page("/buckets", last=last, limit=limit)
                paged += [e["FullPath"] for e in page]
                if len(page) < limit:
                    break
                last = paged[-1].rsplit("/", 1)[-1]
            pages[limit] = paged
        obs["pages"] = pages
        obs["in_bucket"] = [e["FullPath"] for e in ring.list_all(
            "/buckets/bravo")]
        ring.rename("/buckets/alpha/o3.txt", "/buckets/bravo/moved.txt")
        obs["moved"] = (ring.request("GET", "/buckets/bravo/moved.txt"),
                        ring.get_meta("/buckets/alpha/o3.txt"))
        ring.rename("/buckets/alpha/o4.txt", "/buckets/echo/same.txt")
        obs["same_shard"] = ring.request("GET", "/buckets/echo/same.txt")
        obs["recover"] = ring.recover_renames()
        ring.delete("/buckets", recursive=True)
        obs["after_delete"] = [
            ring.get_meta(f"/buckets/{b}/o0.txt") for b in BUCKETS] + [
            ring.list_all("/buckets"), ring.get_meta("/topics/f.txt")
            is not None]
        ring.request("POST", "/buckets/alpha/again.txt", b"x")
        obs["recreated"] = ring.request("GET", "/buckets/alpha/again.txt")
    op_mod.client._lookup_cache.clear()
    retry.BREAKERS.reset()
    return obs


def test_live_tier_matches_reference(tmp_path):
    got = {which: _tier_run(which, str(tmp_path / which))
           for which in ("ref", "port")}
    assert got["port"] == got["ref"]
    run = got["port"]
    assert run["homes"] == [0, 1, 1, 0]
    assert run["held"] == run["assigned"]
    assert all(run["held"])
    assert run["list_all"] == sorted(run["list_all"]) == [
        f"/buckets/{b}" for b in BUCKETS]
    assert all(p == run["list_all"] for p in run["pages"].values())
    assert run["moved"] == (b"alpha-3" * 4, None)
    assert run["after_delete"][:5] == [None] * 4 + [[]]


def _child(which):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_filer_shard_child.py"), which],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_kill_recovery_and_telemetry_match_reference():
    got = {which: _child(which) for which in ("ref", "port")}
    assert got["port"] == got["ref"]
    run = got["port"]
    assert run["cross"] and run["recovered"] == 1 and run["again"] == 0
    assert run["crash_read"] == "survives the kill"
    assert run["crash_old"] is None and run["half_old"] is None
    assert run["half_recovered"] == 1 and run["leftover"] == 0
    assert run["telemetry_ops"] == {"shard0": True, "shard1": True}
    assert run["status_shards"] is True
    assert run["renames"] == {"completed": 1.0, "recovered": 2.0}


def test_sharding_bench_runs_the_port_shards():
    """The metadata bench spawns each shard from its embedded script,
    which imports the port's store and server; two shard processes
    answer its metadata writes and reads. Its rate depends on the host,
    so only that it counted operations is checked."""
    from seaweedfs_tpu_torch.filer.sharding import bench

    assert bench.measure_meta_ops(2, seconds=0.5, threads=2,
                                  top_dirs=4) > 0
