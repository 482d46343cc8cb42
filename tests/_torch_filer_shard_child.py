"""One package's sharded filer tier in a fresh interpreter.

``python tests/_torch_filer_shard_child.py {ref|port}`` starts that
package's ``ClusterHarness`` with two filer shards (the port's on
``device="cpu"``), interrupts a cross-shard rename at its tombstone and
kills the source shard, recovers, finishes a half-done rename, completes
a plain one, waits for both shards' telemetry in the master's view, and
prints one JSON object of what it saw, process-wide counters included
(``FILER_CROSS_RENAMES``, ``FILER_RING_RESOLVES``). A fresh interpreter
keeps those counters free of other tests' traffic.
"""

import importlib
import json
import sys
import time

PACKAGES = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def main(which):
    pkg = PACKAGES[which]
    harness = importlib.import_module(f"{pkg}.server.harness")
    ring_mod = importlib.import_module(f"{pkg}.filer.sharding.ring")
    metrics = importlib.import_module(f"{pkg}.stats.metrics")
    http = importlib.import_module(f"{pkg}.util.http")
    kw = {"device": "cpu"} if which == "port" else {}
    obs = {}
    with harness.ClusterHarness(
            n_volume_servers=2, volumes_per_server=20, n_filer_shards=2,
            telemetry_interval=0.3, **kw) as c:
        c.wait_for_nodes(2)
        ring = c.filer_ring()
        for b in ("alpha", "bravo"):
            ring.request("POST", f"/buckets/{b}/", b"")
        for name, body in (("crash.txt", b"survives the kill"),
                           ("half.txt", b"half-moved"),
                           ("move-me.txt", b"payload!")):
            ring.request("POST", f"/buckets/alpha/{name}", body)
        # interrupted after its tombstone, then the source shard dies
        old, new = "/buckets/alpha/crash.txt", "/buckets/bravo/crash.txt"
        so = ring.shard_of(old)
        obs["cross"] = so != ring.shard_of(new)
        src = ring.urls[so]
        tomb = ring_mod.FilerRing._tombstone_path(old)
        ext = {"seaweed-rename-from": old, "seaweed-rename-to": new}
        ring._put_entry(src, tomb, {"extended": ext})
        c.kill_filer_shard(so)
        c.restart_filer_shard(so)
        obs["recovered"] = ring.recover_renames()
        obs["crash_read"] = ring.request("GET", new).decode()
        obs["crash_old"] = ring.get_meta(old)
        obs["again"] = ring.recover_renames()
        # interrupted after the destination copy, before the delete
        old, new = "/buckets/alpha/half.txt", "/buckets/bravo/half.txt"
        dst = ring.urls[ring.shard_of(new)]
        ring._put_entry(src, ring_mod.FilerRing._tombstone_path(old), {
            "extended": {"seaweed-rename-from": old,
                         "seaweed-rename-to": new}})
        ring._copy_tree(src, dst, old, new, ring._get_meta_url(src, old))
        obs["half_recovered"] = ring.recover_renames()
        obs["half_read"] = ring.request("GET", new).decode()
        obs["half_old"] = ring.get_meta(old)
        ring.rename("/buckets/alpha/move-me.txt", "/buckets/bravo/moved.txt")
        obs["moved_read"] = ring.request(
            "GET", "/buckets/bravo/moved.txt").decode()
        obs["leftover"] = ring.recover_renames()
        deadline = time.time() + 30
        filer, shards = {}, None
        while time.time() < deadline:
            view = http.get_json(f"{c.master.url}/cluster/telemetry")
            filer = view.get("filer") or {}
            shards = http.get_json(f"{c.master.url}/cluster/status").get(
                "FilerShards")
            if shards and all(
                    filer.get(f"shard{i}", {}).get("ops", 0) > 0
                    for i in range(2)):
                break
            time.sleep(0.3)
        obs["telemetry"] = {k: sorted(v) for k, v in sorted(filer.items())}
        obs["telemetry_ops"] = {k: v.get("ops", 0) > 0
                                for k, v in sorted(filer.items())}
        # the master publishes the shard list clients re-resolve from
        obs["status_shards"] = shards == c.filer_urls()
    obs["renames"] = {k[0]: v for k, v in sorted(
        metrics.FILER_CROSS_RENAMES.values().items())}
    return obs


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
