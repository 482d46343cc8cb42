"""Volume admin commands: list, balance, fix.replication, fsck, move,
delete, mark.

Behavioral model: weed/shell/command_volume_list.go, _balance.go,
_fix_replication.go, _fsck.go, _move.go.

The port's copy of ``seaweedfs_tpu/shell/command_volume.py``: the same
commands and output text.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from ..storage import types as t
from ..util import http
from .commands import CommandEnv, command


@command("volume.list", "volume.list # topology + volume inventory")
def cmd_volume_list(env: CommandEnv, args: list[str], out) -> None:
    topo = env.topology()
    out.write(f"max volume id: {topo['max_volume_id']}\n")
    for dc in topo["data_centers"]:
        out.write(f"DataCenter {dc['id']}\n")
        for rack in dc["racks"]:
            out.write(f"  Rack {rack['id']}\n")
            for dn in rack["data_nodes"]:
                out.write(
                    f"    DataNode {dn['id']} "
                    f"volumes:{dn['volume_count']}"
                    f"/{dn['max_volume_count']} "
                    f"ec_shards:{dn['ec_shard_count']}\n"
                )
                for v in sorted(
                    dn["volumes"], key=lambda v: v["id"]
                ):
                    out.write(
                        f"      volume {v['id']} "
                        f"col={v.get('collection','')!r} "
                        f"size={v['size']} files={v['file_count']} "
                        f"del={v['delete_count']} "
                        f"ro={v['read_only']}\n"
                    )
                for e in dn["ec_shards"]:
                    sids = [
                        i for i in range(14)
                        if e["ec_index_bits"] & (1 << i)
                    ]
                    out.write(
                        f"      ec volume {e['id']} shards {sids}\n"
                    )


@command("volume.delete", "volume.delete -volumeId <id> -server <url>")
def cmd_volume_delete(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.delete")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(
        f"{opts.server}/admin/delete_volume", {"volume": opts.volumeId}
    )
    out.write(f"deleted volume {opts.volumeId} on {opts.server}\n")


@command("volume.mark", "volume.mark -volumeId <id> -server <url> [-readonly|-writable]")
def cmd_volume_mark(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.mark")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    p.add_argument("-readonly", action="store_true")
    p.add_argument("-writable", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(
        f"{opts.server}/admin/readonly",
        {"volume": opts.volumeId, "readonly": not opts.writable},
    )
    out.write("ok\n")


@command("volume.move", "volume.move -volumeId <id> -source <url> -target <url>")
def cmd_volume_move(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.move")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-source", required=True)
    p.add_argument("-target", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    # refuse to move onto a server that already holds a replica: the
    # copy would collide, and the copy-failure rollback below could
    # then delete a pre-existing healthy copy
    for dn in env.data_nodes():
        if dn["url"] == opts.target and any(
            v["id"] == opts.volumeId for v in dn["volumes"]
        ):
            raise RuntimeError(
                f"target {opts.target} already has volume "
                f"{opts.volumeId}"
            )
    # freeze writes on the source first: a needle landing mid-copy
    # would be deleted with the source (LiveMoveVolume freeze model)
    http.post_json(
        f"{opts.source}/admin/readonly",
        {"volume": opts.volumeId, "readonly": True},
    )
    try:
        _copy_volume(env, opts.volumeId, opts.source, opts.target)
    except Exception:
        # copy failed (or its reply was lost): best-effort remove any
        # half-landed copy on the target, THEN unfreeze the source —
        # unfreezing while a live target copy exists would let writes
        # diverge between the two
        try:
            http.post_json(
                f"{opts.target}/admin/delete_volume",
                {"volume": opts.volumeId},
            )
        except Exception:
            pass
        http.post_json(
            f"{opts.source}/admin/readonly",
            {"volume": opts.volumeId, "readonly": False},
        )
        raise
    try:
        http.post_json(
            f"{opts.source}/admin/delete_volume",
            {"volume": opts.volumeId},
        )
    except Exception as e:
        # Ambiguous: the source delete may have completed server-side
        # after the client gave up. Deleting the target here could
        # destroy the LAST copy, and unfreezing the source could fork
        # writes — leave both frozen for the operator to resolve.
        raise RuntimeError(
            f"volume.move {opts.volumeId}: copy to {opts.target} "
            f"succeeded but deleting the source on {opts.source} "
            f"failed ({e}); both copies left in place with the source "
            "read-only — verify which copy survives, delete the "
            "other, then volume.mark -writable the survivor"
        ) from e
    http.post_json(
        f"{opts.target}/admin/readonly",
        {"volume": opts.volumeId, "readonly": False},
    )
    out.write(
        f"moved volume {opts.volumeId} {opts.source} -> {opts.target}\n"
    )


def _collection_of(env: CommandEnv, vid: int) -> str:
    for dn in env.data_nodes():
        for v in dn["volumes"]:
            if v["id"] == vid:
                return v.get("collection", "")
    return ""


def _copy_volume(env: CommandEnv, vid: int, source: str, target: str):
    """Copy .dat/.idx over HTTP and load on target (VolumeCopy analog)."""
    collection = _collection_of(env, vid)
    http.post_json(
        f"{target}/admin/volume_copy",
        {"volume": vid, "collection": collection, "source": source},
        timeout=3600,
    )


@command("volume.fix.replication", "volume.fix.replication # re-replicate under-replicated volumes")
def cmd_fix_replication(env: CommandEnv, args: list[str], out) -> None:
    env.confirm_is_locked()
    nodes = env.data_nodes()
    # vid → (replica placement, [servers])
    locations: dict[int, list[str]] = defaultdict(list)
    placements: dict[int, int] = {}
    collections: dict[int, str] = {}
    for dn in nodes:
        for v in dn["volumes"]:
            locations[v["id"]].append(dn["url"])
            placements[v["id"]] = v.get("replica_placement", 0)
            collections[v["id"]] = v.get("collection", "")
    fixed = 0
    for vid, urls in sorted(locations.items()):
        rp = t.ReplicaPlacement.from_byte(placements[vid])
        need = rp.copy_count - len(urls)
        if need <= 0:
            continue
        candidates = [
            dn["url"]
            for dn in sorted(
                nodes,
                key=lambda d: d["volume_count"] - d["max_volume_count"],
            )
            if dn["url"] not in urls
            and dn["volume_count"] < dn["max_volume_count"]
        ]
        for target in candidates[:need]:
            http.post_json(
                f"{target}/admin/volume_copy",
                {
                    "volume": vid,
                    "collection": collections[vid],
                    "source": urls[0],
                },
                timeout=3600,
            )
            out.write(
                f"volume {vid}: replicated {urls[0]} -> {target}\n"
            )
            fixed += 1
    out.write(f"fixed {fixed} replicas\n")


@command("volume.balance", "volume.balance # move volumes from full to empty servers")
def cmd_volume_balance(env: CommandEnv, args: list[str], out) -> None:
    env.confirm_is_locked()
    nodes = env.data_nodes()
    if len(nodes) < 2:
        out.write("nothing to balance\n")
        return
    moved = 0
    while True:
        nodes = env.data_nodes()
        ratios = [
            (dn["volume_count"] / max(1, dn["max_volume_count"]), dn)
            for dn in nodes
        ]
        ratios.sort(key=lambda x: x[0])
        low, high = ratios[0], ratios[-1]
        if high[0] - low[0] <= 1.0 / max(
            1, low[1]["max_volume_count"]
        ):
            break
        candidates = [
            v
            for v in high[1]["volumes"]
            if v["id"] not in {x["id"] for x in low[1]["volumes"]}
        ]
        if not candidates:
            break
        v = candidates[0]
        _copy_volume(env, v["id"], high[1]["url"], low[1]["url"])
        http.post_json(
            f"{high[1]['url']}/admin/delete_volume", {"volume": v["id"]}
        )
        out.write(
            f"moved volume {v['id']} {high[1]['url']} -> "
            f"{low[1]['url']}\n"
        )
        moved += 1
        if moved > 100:
            break
    out.write(f"moved {moved} volumes\n")


@command("volume.tier.upload", "volume.tier.upload -volumeId <id> -server <url> -dest <url|s3://bucket/key> [-s3.endpoint e -s3.backend name] # move .dat to remote tier (credentials from backend.json / WEED_S3_* env)")
def cmd_volume_tier_upload(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.tier.upload")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    p.add_argument("-dest", required=True)
    p.add_argument("-keepLocal", action="store_true")
    p.add_argument("-s3.endpoint", dest="s3_endpoint", default="")
    p.add_argument("-s3.backend", dest="s3_backend", default="default")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    payload = {
        "volume": opts.volumeId,
        "keep_local": opts.keepLocal,
    }
    if opts.dest.startswith("s3://"):
        # cloud tier (s3_backend.go): s3://bucket[/key] + endpoint
        bucket, _, key = opts.dest[len("s3://"):].partition("/")
        # endpoint may come from the named backend config
        # (s3.<name>.endpoint) instead of the flag
        payload["s3"] = {
            "endpoint": opts.s3_endpoint,
            "bucket": bucket,
            "key": key,
            "backend": opts.s3_backend,
        }
    else:
        payload["dest_url"] = opts.dest
    res = http.post_json(
        f"{opts.server}/admin/tier/upload", payload, timeout=3600,
    )
    out.write(
        f"volume {opts.volumeId} tiered to {opts.dest} "
        f"({res.get('size', 0)} bytes)\n"
    )


@command("volume.tier.download", "volume.tier.download -volumeId <id> -server <url> # bring .dat back from remote tier")
def cmd_volume_tier_download(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.tier.download")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(
        f"{opts.server}/admin/tier/download",
        {"volume": opts.volumeId},
        timeout=3600,
    )
    out.write(f"volume {opts.volumeId} un-tiered\n")


@command("volume.fsck", "volume.fsck # verify needle integrity on every volume server")
def cmd_volume_fsck(env: CommandEnv, args: list[str], out) -> None:
    total, bad = 0, 0
    for dn in env.data_nodes():
        try:
            res = http.post_json(f"{dn['url']}/admin/fsck", {})
        except http.HttpError as e:
            out.write(f"{dn['url']}: unreachable ({e})\n")
            continue
        total += res.get("checked", 0)
        for issue in res.get("issues", []):
            bad += 1
            out.write(f"{dn['url']}: {issue}\n")
    out.write(f"checked {total} needles, {bad} issues\n")


@command("volume.copy", "volume.copy -volumeId <id> -source <url> -target <url> # replicate a volume to another server")
def cmd_volume_copy(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.copy")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-source", required=True)
    p.add_argument("-target", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    _copy_volume(env, opts.volumeId, opts.source, opts.target)
    out.write(
        f"copied volume {opts.volumeId} {opts.source} -> "
        f"{opts.target}\n"
    )


@command("volume.mount", "volume.mount -volumeId <id> -server <url> [-collection c] # load an on-disk volume")
def cmd_volume_mount(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.mount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    p.add_argument("-collection", default="")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(
        f"{opts.server}/admin/volume_mount",
        {"volume": opts.volumeId, "collection": opts.collection},
    )
    out.write(f"mounted volume {opts.volumeId} on {opts.server}\n")


@command("volume.unmount", "volume.unmount -volumeId <id> -server <url> # unload a volume, keeping its files")
def cmd_volume_unmount(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.unmount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-server", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(
        f"{opts.server}/admin/volume_unmount",
        {"volume": opts.volumeId},
    )
    out.write(f"unmounted volume {opts.volumeId} on {opts.server}\n")


@command("volume.vacuum", "volume.vacuum [-garbageThreshold 0.3] [-sync] # cluster vacuum pass (async batch when the maintenance plane runs)")
def cmd_volume_vacuum(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.vacuum")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument(
        "-sync", action="store_true",
        help="block while the master walks the cluster (the "
             "pre-maintenance-plane behavior)",
    )
    opts = p.parse_args(args)
    env.confirm_is_locked()
    qs = f"garbageThreshold={opts.garbageThreshold}"
    if opts.sync:
        qs += "&sync=1"
    res = http.post_json(
        f"{env.master_url}/vol/vacuum?{qs}", {}, timeout=3600,
    )
    if res.get("async"):
        # the shell holds the cluster lock, which gates the scheduler:
        # the batch starts once this session unlocks
        out.write(
            f"vacuum batch {res['batch']} enqueued for volumes "
            f"{res.get('enqueued', [])}; progress: "
            f"`maintenance.status` (runs after `unlock`)\n"
        )
        return
    out.write(f"vacuumed volumes: {res.get('vacuumed', [])}\n")


@command("volume.configure.replication", "volume.configure.replication -volumeId <id> -replication <xyz> # rewrite a volume's replica placement")
def cmd_volume_configure_replication(
    env: CommandEnv, args: list[str], out
) -> None:
    p = argparse.ArgumentParser(prog="volume.configure.replication")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-replication", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    from .command_ec import _volume_locations

    for url in _volume_locations(env, opts.volumeId):
        http.post_json(
            f"{url}/admin/volume_configure_replication",
            {
                "volume": opts.volumeId,
                "replication": opts.replication,
            },
        )
        out.write(
            f"volume {opts.volumeId}@{url}: replication = "
            f"{opts.replication}\n"
        )


@command("volume.server.leave", "volume.server.leave -server <url> # gracefully remove a server from the cluster")
def cmd_volume_server_leave(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="volume.server.leave")
    p.add_argument("-server", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.post_json(f"{opts.server}/admin/leave", {})
    out.write(
        f"{opts.server} stopped heartbeating; master will "
        f"unregister it\n"
    )


@command("volume.server.evacuate", "volume.server.evacuate -node <url> # move every volume off a server")
def cmd_volume_server_evacuate(
    env: CommandEnv, args: list[str], out
) -> None:
    """Move all volumes off a node onto peers with free slots
    (weed/shell/command_volume_server_evacuate.go)."""
    p = argparse.ArgumentParser(prog="volume.server.evacuate")
    p.add_argument("-node", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    nodes = env.data_nodes()
    source = next(
        (dn for dn in nodes if dn["url"] == opts.node), None
    )
    if source is None:
        raise RuntimeError(f"node {opts.node} not in topology")
    # live capacity ledger: decremented per move so a long evacuation
    # never overfills a target past max_volume_count
    free = {
        dn["url"]: dn["max_volume_count"] - dn["volume_count"]
        for dn in nodes
        if dn["url"] != opts.node
    }
    holders = {
        dn["url"]: {v["id"] for v in dn["volumes"]}
        for dn in nodes
        if dn["url"] != opts.node
    }
    moved = 0
    for v in list(source["volumes"]):
        candidates = [
            u for u, f in free.items()
            if f > 0 and v["id"] not in holders[u]
        ]
        if not candidates:
            out.write(f"volume {v['id']}: no eligible target\n")
            continue
        target = max(candidates, key=lambda u: free[u])
        # freeze writes during the copy window (same as volume.move)
        http.post_json(
            f"{opts.node}/admin/readonly",
            {"volume": v["id"], "readonly": True},
        )
        _copy_volume(env, v["id"], opts.node, target)
        http.post_json(
            f"{opts.node}/admin/delete_volume", {"volume": v["id"]}
        )
        http.post_json(
            f"{target}/admin/readonly",
            {"volume": v["id"], "readonly": False},
        )
        free[target] -= 1
        holders[target].add(v["id"])
        out.write(f"volume {v['id']}: {opts.node} -> {target}\n")
        moved += 1
    # EC shards move too — decommissioning a node with shards still on
    # it would lose them (command_volume_server_evacuate.go moves both)
    from ..storage.erasure_coding import constants as ecC

    ec_moved = 0
    for e in source.get("ec_shards", []):
        vid = e["id"]
        collection = e.get("collection", "")
        shard_ids = [
            i for i in range(ecC.TOTAL_SHARDS)
            if e["ec_index_bits"] & (1 << i)
        ]
        if not shard_ids:
            continue
        if not free:
            out.write(f"ec volume {vid}: no eligible target\n")
            continue
        # spread the shard set ACROSS targets (all on one node would
        # forfeit EC durability) and charge each node's slot ledger
        targets_sorted = sorted(
            free, key=lambda u: free[u], reverse=True
        )
        assignment: dict[str, list[int]] = {}
        for i, sid in enumerate(shard_ids):
            assignment.setdefault(
                targets_sorted[i % len(targets_sorted)], []
            ).append(sid)
        for target, sids in assignment.items():
            http.post_json(
                f"{target}/admin/ec/copy",
                {
                    "volume": vid,
                    "collection": collection,
                    "shard_ids": sids,
                    "source": opts.node,
                    "copy_ecx_file": True,
                },
                timeout=3600,
            )
            http.post_json(
                f"{target}/admin/ec/mount",
                {
                    "volume": vid,
                    "collection": collection,
                    "shard_ids": sids,
                },
            )
            free[target] = max(0, free[target] - 1)
            out.write(
                f"ec volume {vid} shards {sids}: "
                f"{opts.node} -> {target}\n"
            )
        http.post_json(
            f"{opts.node}/admin/ec/unmount",
            {"volume": vid, "shard_ids": shard_ids},
        )
        http.post_json(
            f"{opts.node}/admin/ec/delete_shards",
            {
                "volume": vid,
                "collection": collection,
                "shard_ids": shard_ids,
            },
        )
        ec_moved += 1
    out.write(
        f"evacuated {moved} volumes + {ec_moved} ec volumes off "
        f"{opts.node}\n"
    )
