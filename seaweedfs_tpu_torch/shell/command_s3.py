"""S3 admin shell commands (weed/shell command_s3_configure analog).

The port's copy of ``seaweedfs_tpu/shell/command_s3.py``.
"""

from __future__ import annotations

import argparse
import json

from ..util import http
from .commands import CommandEnv, command

IDENTITIES_PATH = "/etc/iam/identities.json"


@command(
    "s3.configure",
    "s3.configure -filer f -user name -access_key k -secret_key s "
    "[-actions Read,Write,...] # upsert an S3 identity",
)
def cmd_s3_configure(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="s3.configure")
    p.add_argument("-filer", default=getattr(env, "filer_url", ""))
    p.add_argument("-user", required=True)
    p.add_argument("-access_key", required=True)
    p.add_argument("-secret_key", required=True)
    p.add_argument("-actions", default="Admin")
    p.add_argument("-delete", action="store_true")
    opts = p.parse_args(args)
    if not opts.filer:
        raise RuntimeError("need -filer (or fs.configure first)")
    try:
        cfg = json.loads(
            http.request("GET", f"{opts.filer}{IDENTITIES_PATH}")
        )
    except http.HttpError:
        cfg = {"identities": []}
    cfg["identities"] = [
        i for i in cfg["identities"] if i["name"] != opts.user
    ]
    if not opts.delete:
        cfg["identities"].append(
            {
                "name": opts.user,
                "credentials": [
                    {
                        "accessKey": opts.access_key,
                        "secretKey": opts.secret_key,
                    }
                ],
                "actions": opts.actions.split(","),
            }
        )
    http.request(
        "POST",
        f"{opts.filer}{IDENTITIES_PATH}",
        json.dumps(cfg).encode(),
        {"Content-Type": "application/json"},
    )
    out.write(
        f"{'deleted' if opts.delete else 'configured'} s3 identity "
        f"{opts.user}\n"
    )


@command("s3.bucket.list", "s3.bucket.list [-filer f] # list buckets")
def cmd_s3_bucket_list(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="s3.bucket.list")
    p.add_argument("-filer", default=getattr(env, "filer_url", ""))
    opts = p.parse_args(args)
    listing = http.get_json(f"{opts.filer}/buckets/?limit=1000")
    for e in listing.get("Entries") or []:
        if e["IsDirectory"]:
            out.write(
                e["FullPath"].rsplit("/", 1)[-1] + "\n"
            )


@command("s3.bucket.create", "s3.bucket.create -name <bucket> # create a bucket")
def cmd_s3_bucket_create(env: CommandEnv, args: list[str], out) -> None:
    import argparse

    from .command_fs import _filer_of

    filer, rest = _filer_of(env, args)
    p = argparse.ArgumentParser(prog="s3.bucket.create")
    p.add_argument("-name", required=True)
    opts = p.parse_args(rest)
    http.request("POST", f"{filer}/buckets/{opts.name}/", b"")
    out.write(f"created bucket {opts.name}\n")


@command("s3.bucket.delete", "s3.bucket.delete -name <bucket> # delete a bucket and its objects")
def cmd_s3_bucket_delete(env: CommandEnv, args: list[str], out) -> None:
    import argparse

    from .command_fs import _filer_of

    filer, rest = _filer_of(env, args)
    p = argparse.ArgumentParser(prog="s3.bucket.delete")
    p.add_argument("-name", required=True)
    opts = p.parse_args(rest)
    http.request(
        "DELETE", f"{filer}/buckets/{opts.name}?recursive=true"
    )
    out.write(f"deleted bucket {opts.name}\n")
