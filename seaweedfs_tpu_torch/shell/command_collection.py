"""Collection commands (weed/shell/command_collection_*.go).

The port's copy of ``seaweedfs_tpu/shell/command_collection.py``.
"""

from __future__ import annotations

import argparse

from ..util import http
from .commands import CommandEnv, command


@command("collection.list", "collection.list # list collections")
def cmd_collection_list(env: CommandEnv, args: list[str], out) -> None:
    names = set()
    for dn in env.data_nodes():
        for v in dn["volumes"]:
            names.add(v.get("collection", "") or "<default>")
    for name in sorted(names):
        out.write(f"collection: {name}\n")


@command("collection.delete", "collection.delete -collection <name>")
def cmd_collection_delete(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="collection.delete")
    p.add_argument("-collection", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    http.get_json(
        f"{env.master_url}/col/delete?collection={opts.collection}"
    )
    out.write(f"deleted collection {opts.collection}\n")
