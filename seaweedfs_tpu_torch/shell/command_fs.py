"""Filesystem shell commands over a filer (weed/shell fs.* analogs).

The port's copy of ``seaweedfs_tpu/shell/command_fs.py``.
"""

from __future__ import annotations

import argparse
import json
import urllib.parse

from ..util import http
from .commands import CommandEnv, command


def _filer_of(env: CommandEnv, args: list[str]) -> tuple[str, list[str]]:
    """Pop a -filer flag or use the env's configured filer."""
    out = []
    filer = getattr(env, "filer_url", "")
    it = iter(args)
    for a in it:
        if a == "-filer":
            filer = next(it, "")
        else:
            out.append(a)
    if not filer:
        raise RuntimeError(
            "no filer configured; pass -filer host:port or run "
            "`fs.configure -filer host:port`"
        )
    return filer, out


@command("fs.configure", "fs.configure -filer <host:port> # set the shell's filer")
def cmd_fs_configure(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="fs.configure")
    p.add_argument("-filer", required=True)
    opts = p.parse_args(args)
    env.filer_url = opts.filer
    out.write(f"using filer {opts.filer}\n")


def _resolve(env: CommandEnv, path: str) -> str:
    """Resolve a (possibly relative) path against the shell's working
    directory (fs.cd), collapsing '.' and '..'."""
    cwd = getattr(env, "cwd", "/")
    if not path.startswith("/"):
        path = cwd.rstrip("/") + "/" + path
    parts = []
    for seg in path.split("/"):
        if seg in ("", "."):
            continue
        if seg == "..":
            if parts:
                parts.pop()
            continue
        parts.append(seg)
    return "/" + "/".join(parts)


def _list(filer: str, path: str) -> list[dict]:
    """Full (PAGINATED) listing of one directory — a single capped
    request would silently truncate large directories."""
    base = path.rstrip("/") or "/"
    out: list[dict] = []
    last = ""
    while True:
        qs = urllib.parse.urlencode(
            {"limit": 1000, "lastFileName": last}
        )
        listing = http.get_json(f"{filer}{base}/?{qs}")
        entries = listing.get("Entries") or []
        out.extend(entries)
        if not listing.get("ShouldDisplayLoadMore") or not entries:
            return out
        last = entries[-1]["FullPath"].rsplit("/", 1)[-1]


@command("fs.ls", "fs.ls [-filer f] [path] # list a filer directory")
def cmd_fs_ls(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    path = _resolve(env, rest[0] if rest else ".")
    for e in _list(filer, path):
        name = e["FullPath"].rsplit("/", 1)[-1]
        kind = "/" if e["IsDirectory"] else ""
        out.write(f"{e.get('FileSize', 0):>12} {name}{kind}\n")


@command("fs.cat", "fs.cat [-filer f] <path> # print file content")
def cmd_fs_cat(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    data = http.request("GET", f"{filer}{_resolve(env, rest[0])}")
    out.write(data.decode("utf8", "replace"))


@command("fs.du", "fs.du [-filer f] [path] # disk usage of a subtree")
def cmd_fs_du(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    path = _resolve(env, rest[0] if rest else ".")

    def walk(p: str) -> tuple[int, int]:
        files, size = 0, 0
        for e in _list(filer, p):
            if e["IsDirectory"]:
                f2, s2 = walk(e["FullPath"])
                files += f2
                size += s2
            else:
                files += 1
                size += e.get("FileSize", 0)
        return files, size

    files, size = walk(path)
    out.write(f"{size} bytes in {files} files under {path}\n")


@command("fs.tree", "fs.tree [-filer f] [path] # recursive listing")
def cmd_fs_tree(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    path = _resolve(env, rest[0] if rest else ".")

    def walk(p: str, indent: str):
        for e in _list(filer, p):
            name = e["FullPath"].rsplit("/", 1)[-1]
            if e["IsDirectory"]:
                out.write(f"{indent}{name}/\n")
                walk(e["FullPath"], indent + "  ")
            else:
                out.write(f"{indent}{name}\n")

    out.write(f"{path}\n")
    walk(path, "  ")


@command("fs.mv", "fs.mv [-filer f] <src> <dst> # move/rename")
def cmd_fs_mv(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    src, dst = _resolve(env, rest[0]), _resolve(env, rest[1])
    import urllib.parse

    http.request(
        "POST", f"{filer}{dst}?mv.from={urllib.parse.quote(src)}", b""
    )
    out.write(f"moved {src} -> {dst}\n")


@command("fs.rm", "fs.rm [-filer f] [-r] <path> # delete")
def cmd_fs_rm(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    recursive = "-r" in rest
    paths = [_resolve(env, a) for a in rest if a != "-r"]
    for p in paths:
        qs = "?recursive=true" if recursive else ""
        http.request("DELETE", f"{filer}{p}{qs}")
        out.write(f"deleted {p}\n")


@command("fs.mkdir", "fs.mkdir [-filer f] <path>")
def cmd_fs_mkdir(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    path = _resolve(env, rest[0])
    http.request("POST", f"{filer}{path.rstrip('/')}/", b"")
    out.write(f"created {path}\n")


@command("fs.meta.cat", "fs.meta.cat [-filer f] <path> # print entry metadata")
def cmd_fs_meta_cat(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    path = _resolve(env, rest[0])
    parent = path.rsplit("/", 1)[0] or "/"
    name = path.rsplit("/", 1)[-1]
    for e in _list(filer, parent):
        if e["FullPath"].rsplit("/", 1)[-1] == name:
            out.write(json.dumps(e, indent=2) + "\n")
            return
    raise RuntimeError(f"{path} not found")


@command("fs.cd", "fs.cd <dir> # change the shell's working directory")
def cmd_fs_cd(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    target = _resolve(env, rest[0] if rest else "/")
    if target != "/":
        meta = http.get_json(f"{filer}{target}?meta=true")
        mode = (meta.get("attr") or {}).get("mode", 0)
        if not mode & 0o40000:
            raise RuntimeError(f"{target} is not a directory")
    env.cwd = target or "/"
    out.write(f"{env.cwd}\n")


@command("fs.pwd", "fs.pwd # print the shell's working directory")
def cmd_fs_pwd(env: CommandEnv, args: list[str], out) -> None:
    out.write(f"{getattr(env, 'cwd', '/')}\n")


def _walk(filer: str, path: str):
    """Depth-first walk of the filer tree yielding entry dicts."""
    for e in _list(filer, path):
        yield e
        if e["IsDirectory"]:
            yield from _walk(filer, e["FullPath"])


@command("fs.meta.save", "fs.meta.save [-filer f] -o <file> [path] # dump filer metadata (entries + chunk lists) to a local ndjson file")
def cmd_fs_meta_save(env: CommandEnv, args: list[str], out) -> None:
    """Metadata backup (weed/shell/command_fs_meta_save.go): every
    entry's full metadata — including chunk fids — written as ndjson;
    restorable on the SAME cluster with fs.meta.load."""
    filer, rest = _filer_of(env, args)
    p = argparse.ArgumentParser(prog="fs.meta.save")
    p.add_argument("-o", required=True)
    p.add_argument("path", nargs="?", default=".")
    opts = p.parse_args(rest)
    opts.path = _resolve(env, opts.path)
    n = 0
    with open(opts.o, "w") as f:
        for e in _walk(filer, opts.path):
            if e["IsDirectory"]:
                rec = {"dir": e["FullPath"]}
            else:
                meta = http.get_json(
                    f"{filer}{e['FullPath']}?meta=true"
                )
                rec = {"file": e["FullPath"], "entry": meta}
            f.write(json.dumps(rec) + "\n")
            n += 1
    out.write(f"saved {n} entries from {opts.path} to {opts.o}\n")


@command("fs.meta.load", "fs.meta.load [-filer f] -i <file> # restore filer metadata from an fs.meta.save dump")
def cmd_fs_meta_load(env: CommandEnv, args: list[str], out) -> None:
    filer, rest = _filer_of(env, args)
    p = argparse.ArgumentParser(prog="fs.meta.load")
    p.add_argument("-i", required=True)
    opts = p.parse_args(rest)
    n = 0
    with open(opts.i) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if d := rec.get("dir"):
                http.request(
                    "POST", f"{filer}{d.rstrip('/')}/", b""
                )
            else:
                http.request(
                    "POST",
                    f"{filer}{rec['file']}?entry=true",
                    json.dumps(rec["entry"]).encode(),
                    {"Content-Type": "application/json"},
                )
            n += 1
    out.write(f"loaded {n} entries from {opts.i}\n")
