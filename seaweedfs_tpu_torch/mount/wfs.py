"""WFS: the mounted filesystem over filer HTTP.

Behavioral model: weed/filesys/wfs.go + dirty_page.go +
dirty_page_interval.go — an attribute/listing cache refreshed on
mutation, and interval-buffered write-back: writes accumulate in merged
dirty spans with bounded memory; spans reaching chunk size are uploaded
as FileChunks immediately, and flush commits the entry's chunk list to
the filer (CreateEntry analog), so a 100 GB sequential write holds
O(chunk_size) RAM in the mount.

The port's copy of ``seaweedfs_tpu/mount/wfs.py``; ``close()`` also
joins the meta-subscription threads.
"""

from __future__ import annotations

import base64
import errno
import json
import stat as stat_mod
import threading
import time

from ..filer import sharding
from ..util import http
from ..util import retry as retry_mod
from .page_writer import PageWriter

DIR_MODE = stat_mod.S_IFDIR | 0o755
FILE_MODE = stat_mod.S_IFREG | 0o644
LINK_MODE = stat_mod.S_IFLNK | 0o777

# xattrs live in entry.extended under this prefix, values base64 so the
# JSON entry form can carry binary (weed/filesys/xattr.go XATTR_PREFIX)
XATTR_PREFIX = "xattr-"
XATTR_CREATE, XATTR_REPLACE = 1, 2


class _OpenFile:
    """Write-back state for one path with a writer handle open.

    Carries its own lock so chunk uploads and entry commits for one
    file never stall FUSE operations on other files (the global WFS
    lock only guards the writer/attr maps)."""

    def __init__(self, pw: PageWriter, need_base: bool):
        self.base: dict | None = None
        self.base_loaded = not need_base
        self.pw = pw
        self.size = 0
        self.lock = threading.RLock()


def _entry_size(entry: dict | None) -> int:
    if not entry:
        return 0
    chunks_end = max(
        (c["offset"] + c["size"] for c in entry.get("chunks", [])),
        default=0,
    )
    return max(entry.get("attr", {}).get("file_size", 0), chunks_end)


class WFS:
    def __init__(
        self,
        filer_url: str,
        filer_root: str = "/",
        chunk_size: int = 4 * 1024 * 1024,
        subscribe_meta: bool = True,
    ):
        # one URL, an ordered shard list, or a FilerRing: every
        # metadata RPC routes to the shard owning its path
        self.ring = sharding.ring_of(filer_url)
        self.filer_url = self.ring.primary
        self.root = filer_root.rstrip("/")
        self.chunk_size = chunk_size
        self._writers: dict[str, _OpenFile] = {}
        self._attr_cache: dict[str, tuple[float, dict]] = {}
        self._inval_gen = 0
        self._lock = threading.RLock()
        # with the meta subscription invalidating pushed changes, the
        # attr cache can live much longer than the blind 1s TTL
        # (weed/filesys/meta_cache kept fresh by SubscribeMetadata)
        self._cache_ttl = 1.0
        self._running = True
        if subscribe_meta:
            self._cache_ttl = 30.0
            # one subscription per shard: events for a path only ever
            # appear on the shard owning it (bounded: MAX_SHARDS)
            self._meta_threads = [
                threading.Thread(
                    target=self._meta_subscribe_loop,
                    args=(base,),
                    daemon=True,
                )
                for base in self.ring.urls
            ]
            for t in self._meta_threads:
                t.start()

    def close(self) -> None:
        """Stop the meta subscription and join its threads: each ends
        once its long-poll in flight returns (at most its 15 s
        timeout), so a closed WFS leaves no thread behind."""
        self._running = False
        for t in getattr(self, "_meta_threads", ()):
            t.join(timeout=20)

    def _meta_subscribe_loop(self, base: str) -> None:
        """Long-poll one filer shard's meta events and invalidate
        cached attrs for every touched path — external writers become
        visible immediately instead of after the TTL (meta_cache/ +
        filer_grpc_server_sub_meta.go model). The cursor comes from the
        SERVER clock (events are stamped there; a skewed client clock
        would silently skip events). Any failure degrades to the blind
        short TTL instead of serving 30s-stale attrs."""
        offset = None
        try:
            while self._running:
                try:
                    if offset is None:
                        # bootstrap the cursor from the filer's clock
                        out = http.get_json(
                            f"{base}/meta/events"
                            f"?since=0&limit=0",
                            timeout=10, retry=retry_mod.LOOKUP,
                        )
                        offset = int(out.get("now_ns") or 0)
                        if not offset:
                            raise ValueError("filer sent no now_ns")
                        continue
                    out = http.get_json(
                        f"{base}/meta/events?since={offset}"
                        f"&wait=true&timeout=10",
                        timeout=15, retry=retry_mod.LOOKUP,
                    )
                    for ev in out.get("events", []):
                        offset = max(offset, int(ev["ts_ns"]))
                        self._invalidate_from_event(ev)
                except Exception:
                    time.sleep(1.0)
        finally:
            # no subscription → no push invalidation: fall back to the
            # conservative TTL rather than serving long-stale attrs
            self._cache_ttl = 1.0

    def _rel_path(self, fp: str) -> str | None:
        prefix = self.root
        if fp == prefix:
            return "/"
        if fp.startswith(prefix + "/"):
            return fp[len(prefix):]
        return None

    def _invalidate_from_event(self, ev: dict) -> None:
        paths = set()
        for entry in (ev.get("old_entry"), ev.get("new_entry")):
            if entry and entry.get("full_path"):
                if (p := self._rel_path(entry["full_path"])) is not None:
                    paths.add(p)
        if d := ev.get("directory"):
            if (p := self._rel_path(d)) is not None:
                paths.add(p)
        for p in paths:
            self._invalidate(p)

    # -- helpers ---------------------------------------------------------

    def _fp(self, path: str) -> str:
        return f"{self.root}{path}" if path != "/" else (
            self.root or "/"
        )

    def _u(self, path: str) -> str:
        """The owning shard's base URL + full filer path."""
        fp = self._fp(path)
        return f"{self.ring.url_for(fp)}{fp}"

    def _list_dir(self, path: str) -> list[dict]:
        # fan-out roots merge pages across every shard in the ring
        return self.ring.list_page(
            self._fp(path).rstrip("/") or "/", limit=10000
        )

    def _invalidate(self, path: str) -> None:
        with self._lock:
            self._attr_cache.pop(path, None)
            parent = path.rsplit("/", 1)[0] or "/"
            self._attr_cache.pop(parent, None)
            # any fetch that STARTED before this invalidation must not
            # cache its (possibly stale) result afterwards
            self._inval_gen += 1

    def _entry_attrs(self, e: dict) -> dict:
        raw_mode = int(e.get("Mode", 0))
        target = e.get("SymlinkTarget", "")
        if e["IsDirectory"]:
            mode = stat_mod.S_IFDIR | ((raw_mode & 0o7777) or 0o755)
            nlink = 2
        elif stat_mod.S_ISLNK(raw_mode) or target:
            mode = LINK_MODE
            nlink = 1
        else:
            mode = stat_mod.S_IFREG | ((raw_mode & 0o7777) or 0o644)
            nlink = int(e.get("HardLinkCounter", 0)) or 1
        return {
            "st_mode": mode,
            "st_size": (
                len(target) if target else e.get("FileSize", 0)
            ),
            "st_mtime": e.get("Mtime", 0),
            "st_nlink": nlink,
        }

    # -- dirty-page plumbing --------------------------------------------

    def _fetch_meta(self, path: str) -> dict | None:
        try:
            return json.loads(
                http.request(
                    "GET", f"{self._u(path)}?meta=true"
                )
            )
        except http.HttpError as e:
            if e.status == 404:
                return None
            # a transient filer error must NOT look like "new file" —
            # committing against base=None would garbage-collect every
            # existing chunk of the entry
            raise OSError(errno.EIO, f"filer meta: {e}")

    def _upload_chunk(self, data: bytes) -> str:
        """Assign through the filer, upload straight to the volume
        server, re-assigning on failure
        (weed/filesys/dirty_page.go saveToStorage +
        weed/operation/upload_content.go retry model)."""
        from .. import operation

        last: Exception | None = None
        for _ in range(3):
            a = http.get_json(f"{self.filer_url}/__assign")
            if a.get("error"):
                last = OSError(errno.EIO, a["error"])
                continue
            try:
                operation.upload(
                    a["url"], a["fid"], data, jwt=a.get("auth", "")
                )
                return a["fid"]
            except http.HttpError as e:
                last = e
        raise OSError(errno.EIO, f"chunk upload failed: {last}")

    def _writer(
        self, path: str, base_from_filer: bool
    ) -> _OpenFile:
        """Get-or-register the write-back state for a path. Cheap (no
        HTTP) so it can run under the global lock; the base-entry fetch
        happens lazily under the per-file lock in _ensure_base."""
        with self._lock:
            of = self._writers.get(path)
            if of is None:
                of = _OpenFile(
                    PageWriter(self._upload_chunk, self.chunk_size),
                    need_base=base_from_filer,
                )
                self._writers[path] = of
            return of

    def _ensure_base(self, path: str, of: _OpenFile) -> None:
        """Load the committed entry once (caller holds of.lock)."""
        if of.base_loaded:
            return
        of.base = self._fetch_meta(path)
        of.size = _entry_size(of.base) if of.base else 0
        of.pw.extent = of.size
        of.base_loaded = True

    def _commit(self, path: str, of: _OpenFile) -> None:
        """Flush dirty spans and commit base+new chunks as the entry
        (the reference's wfs flush → filer CreateEntry with appended
        chunks; overlap resolution happens in the filer chunk
        algebra)."""
        new_chunks = of.pw.flush()
        if of.base is not None and not new_chunks and (
            of.size == _entry_size(of.base)
        ):
            return  # nothing changed
        base = of.base or {}
        attr = dict(base.get("attr") or {})
        attr["file_size"] = max(of.size, of.pw.extent)
        attr["mtime"] = time.time()
        if new_chunks:
            # content changed; the old whole-file md5 no longer holds
            attr["md5"] = ""
        entry = {
            "attr": attr,
            "chunks": list(base.get("chunks") or []) + new_chunks,
            "extended": base.get("extended") or {},
            "hard_link_id": base.get("hard_link_id") or "",
        }
        http.request(
            "POST",
            f"{self._u(path)}?entry=true",
            json.dumps(entry).encode(),
            {"Content-Type": "application/json"},
            timeout=120,
        )
        committed = dict(entry)
        committed["full_path"] = self._fp(path)
        of.base = committed
        of.size = _entry_size(committed)
        self._invalidate(path)

    # -- fuse operations -------------------------------------------------

    def getattr(self, path: str) -> dict:
        if path == "/":
            return {"st_mode": DIR_MODE, "st_nlink": 2}
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                # the committed size must be known before reporting —
                # O_APPEND offsets come from the kernel's view of this
                self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                return {
                    "st_mode": FILE_MODE,
                    "st_size": max(of.size, of.pw.extent),
                    "st_mtime": int(time.time()),
                }
        with self._lock:
            hit = self._attr_cache.get(path)
            if hit and time.monotonic() - hit[0] < self._cache_ttl:
                return hit[1]
            gen0 = self._inval_gen
        parent = path.rsplit("/", 1)[0] or "/"
        name = path.rsplit("/", 1)[-1]
        try:
            entries = self._list_dir(parent)
        except http.HttpError:
            raise OSError(errno.ENOENT, path)
        for e in entries:
            if e["FullPath"].rsplit("/", 1)[-1] == name:
                attrs = self._entry_attrs(e)
                hardlinked = (
                    not e["IsDirectory"]
                    and int(e.get("HardLinkCounter", 0)) >= 2
                )
                with self._lock:
                    if self._inval_gen == gen0 and not hardlinked:
                        # no invalidation raced this fetch; safe to
                        # cache under the long push-backed TTL.
                        # Hardlinked entries are never cached: a
                        # mutation through a sibling name changes THIS
                        # path's nlink/content and the path-keyed
                        # cache has no way to see it.
                        self._attr_cache[path] = (
                            time.monotonic(), attrs
                        )
                return attrs
        raise OSError(errno.ENOENT, path)

    def readdir(self, path: str) -> list[str]:
        try:
            entries = self._list_dir(path)
        except http.HttpError:
            raise OSError(errno.ENOENT, path)
        return [
            name
            for e in entries
            if (name := e["FullPath"].rsplit("/", 1)[-1])
        ]

    def read(self, path: str, size: int, offset: int, fh) -> bytes:
        end = offset + size
        dirty_spans: list[tuple[int, bytes]] = []
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                if of.pw.pages.covers(offset, size):
                    return of.pw.pages.read(offset, size)
                if any(
                    c["offset"] < end
                    and c["offset"] + c["size"] > offset
                    for c in of.pw.chunks
                ):
                    # range touches saved-but-uncommitted chunks the
                    # mount can't overlay from memory: commit so the
                    # filer view is consistent (clears pages + chunks)
                    self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                    self._commit(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                else:
                    dirty_spans = [
                        (s, bytes(b))
                        for s, b in of.pw.pages.intervals
                        if s < end and s + len(b) > offset
                    ]
        try:
            data = http.request(
                "GET",
                self._u(path),
                headers={
                    "Range": f"bytes={offset}-{end - 1}"
                },
            )
        except http.HttpError as e:
            if e.status == 416:  # read at/past EOF
                data = b""
            else:
                raise OSError(
                    errno.ENOENT if e.status == 404 else errno.EIO,
                    path,
                )
        if not dirty_spans:
            return data
        # overlay in-memory dirty spans on the committed view
        # (the reference reads through dirty pages the same way,
        # weed/filesys/file.go readFromDirtyPages + readFromChunks)
        want = min(
            size,
            max(
                [len(data)]
                + [min(s + len(b), end) - offset
                   for s, b in dirty_spans]
            ),
        )
        buf = bytearray(want)
        buf[: len(data)] = data
        for s, b in dirty_spans:
            lo = max(s, offset)
            hi = min(s + len(b), end)
            buf[lo - offset : hi - offset] = b[lo - s : hi - s]
        return bytes(buf)

    def create(self, path: str, mode) -> int:
        self._writer(path, base_from_filer=False)
        self._invalidate(path)
        return 0

    def open(self, path: str, flags) -> int:
        import os as _os

        if flags & (_os.O_WRONLY | _os.O_RDWR):
            self._writer(
                path, base_from_filer=not (flags & _os.O_TRUNC)
            )
        return 0

    def write(self, path: str, data: bytes, offset: int, fh) -> int:
        of = self._writer(path, base_from_filer=True)
        with of.lock:
            # chunk uploads triggered by this write block only THIS
            # file; getattr/read on other paths proceed
            self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
            of.pw.write(offset, data)
            of.size = max(of.size, offset + len(data))
        return len(data)

    def truncate(self, path: str, length: int) -> None:
        with self._lock:
            of = self._writers.get(path)
        if of is None:
            # no open handle: use a PRIVATE unregistered writer — a
            # registered one would have no release() to clean it up,
            # and popping it later could race a concurrent open()
            of = _OpenFile(
                PageWriter(self._upload_chunk, self.chunk_size),
                need_base=True,
            )
        self._truncate_locked(path, length, of)
        self._invalidate(path)

    def _truncate_locked(
        self, path: str, length: int, of: _OpenFile
    ) -> None:
        with of.lock:
            self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
            self._commit(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
            base = of.base or {}
            chunks = []
            for c in base.get("chunks") or []:
                if c["offset"] >= length:
                    continue
                if c["offset"] + c["size"] > length:
                    c = dict(c, size=length - c["offset"])
                chunks.append(c)
            attr = dict(base.get("attr") or {})
            if length != _entry_size(base):
                attr["md5"] = ""
            attr["file_size"] = length
            entry = {
                "attr": attr,
                "chunks": chunks,
                "extended": base.get("extended") or {},
                "hard_link_id": base.get("hard_link_id") or "",
            }
            http.request(  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                "POST",
                f"{self._u(path)}?entry=true",
                json.dumps(entry).encode(),
                {"Content-Type": "application/json"},
            )
            entry["full_path"] = self._fp(path)
            of.base = entry
            of.size = length
            of.pw.extent = min(of.pw.extent, length)

    def flush(self, path: str, fh) -> None:
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                self._commit(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design

    def release(self, path: str, fh) -> None:
        with self._lock:
            of = self._writers.pop(path, None)
        if of is not None:
            with of.lock:
                self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                self._commit(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design

    def unlink(self, path: str) -> None:
        try:
            http.request(
                "DELETE", self._u(path)
            )
        except http.HttpError:
            raise OSError(errno.ENOENT, path)
        with self._lock:
            self._writers.pop(path, None)
        self._invalidate(path)

    def mkdir(self, path: str, mode) -> None:
        http.request(
            "POST", f"{self._u(path)}/", b""
        )
        self._invalidate(path)

    def rmdir(self, path: str) -> None:
        try:
            http.request(
                "DELETE",
                f"{self._u(path)}?recursive=true",
            )
        except http.HttpError:
            raise OSError(errno.ENOENT, path)
        self._invalidate(path)

    def rename(self, old: str, new: str) -> None:
        # same-shard renames keep the filer's transactional mv.from;
        # cross-shard renames run the ring's tombstone-guarded
        # create-then-delete protocol
        try:
            self.ring.rename(self._fp(old), self._fp(new))
        except http.HttpError as e:
            raise OSError(
                errno.ENOENT if e.status == 404 else errno.EIO,
                f"rename {old} -> {new}: {e}",
            )
        self._invalidate(old)
        self._invalidate(new)

    # -- symlinks / hardlinks (weed/filesys/dir_link.go) ----------------

    def symlink(self, target: str, linkpath: str) -> None:
        entry = {
            "attr": {
                "mode": LINK_MODE,
                "symlink_target": target,
                "mtime": time.time(),
            },
            "chunks": [],
            "extended": {},
        }
        http.request(
            "POST",
            f"{self._u(linkpath)}?entry=true",
            json.dumps(entry).encode(),
            {"Content-Type": "application/json"},
        )
        self._invalidate(linkpath)

    def readlink(self, path: str) -> str:
        meta = self._fetch_meta(path)
        if meta is None:
            raise OSError(errno.ENOENT, path)
        target = (meta.get("attr") or {}).get("symlink_target", "")
        if not target:
            raise OSError(errno.EINVAL, f"{path} is not a symlink")
        return target

    def link(self, old: str, new: str) -> None:
        import urllib.parse

        fp_old, fp_new = self._fp(old), self._fp(new)
        if self.ring.shard_of(fp_old) != self.ring.shard_of(fp_new):
            # a hardlink shares one inode: it cannot span two shard
            # stores. Same answer a kernel gives across filesystems.
            raise OSError(
                errno.EXDEV, f"link {old} -> {new}: crosses shards"
            )
        try:
            http.request(
                "POST",
                f"{self.ring.url_for(fp_new)}{fp_new}"
                f"?ln.from={urllib.parse.quote(fp_old)}",
                b"",
            )
        except http.HttpError as e:
            code = {404: errno.ENOENT, 409: errno.EEXIST,
                    400: errno.EPERM}.get(e.status, errno.EIO)
            raise OSError(code, f"link {old} -> {new}: {e}")
        self._invalidate(old)
        self._invalidate(new)

    # -- xattrs (weed/filesys/xattr.go; stored in entry.extended) -------

    def _xattr_load(self, path: str) -> dict:
        # cp --preserve=xattr and rsync -X set xattrs on a still-open
        # destination fd: commit any pending writer first so the entry
        # exists (and its chunks are final) before we edit its meta
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                self._commit(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
        meta = self._fetch_meta(path)
        if meta is None:
            raise OSError(errno.ENOENT, path)
        return meta

    def _xattr_store(self, path: str, meta: dict) -> None:
        http.request(
            "POST",
            f"{self._u(path)}?entry=true",
            json.dumps(meta).encode(),
            {"Content-Type": "application/json"},
        )
        # keep any open writer's base in sync so its eventual commit
        # re-posts the new xattrs instead of the stale set
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                if isinstance(of.base, dict):
                    of.base["extended"] = meta.get("extended", {})
        self._invalidate(path)

    def setxattr(
        self, path: str, name: str, value: bytes, flags: int
    ) -> None:
        meta = self._xattr_load(path)
        ext = meta.setdefault("extended", {})
        key = XATTR_PREFIX + name
        if flags & XATTR_CREATE and key in ext:
            raise OSError(errno.EEXIST, name)
        if flags & XATTR_REPLACE and key not in ext:
            raise OSError(errno.ENODATA, name)
        ext[key] = base64.b64encode(value).decode()
        self._xattr_store(path, meta)

    def _xattr_read(self, path: str) -> dict:
        """Read-only extended map. Never commits, and answers from the
        open writer's in-memory base when one exists — the kernel
        probes getxattr("security.capability") before EVERY write(2)
        on FUSE (file_remove_privs), so this path must not cost an
        HTTP round-trip (let alone a dirty-page flush) mid-stream."""
        with self._lock:
            of = self._writers.get(path)
        if of is not None:
            with of.lock:
                # at most one meta fetch per open handle; afterwards
                # every probe answers from memory
                self._ensure_base(path, of)  # weedcheck: ignore[lock-held-across-blocking]: per-open-file lock; FUSE write-back serializes meta/commit RPCs per handle by design
                return (of.base or {}).get("extended") or {}
        meta = self._fetch_meta(path)
        if meta is None:
            raise OSError(errno.ENOENT, path)
        return meta.get("extended") or {}

    def getxattr(self, path: str, name: str) -> bytes:
        val = self._xattr_read(path).get(XATTR_PREFIX + name)
        if val is None:
            raise OSError(errno.ENODATA, name)
        return base64.b64decode(val)

    def listxattr(self, path: str) -> list[str]:
        return [
            k[len(XATTR_PREFIX):]
            for k in self._xattr_read(path)
            if k.startswith(XATTR_PREFIX)
        ]

    def removexattr(self, path: str, name: str) -> None:
        meta = self._xattr_load(path)
        ext = meta.get("extended") or {}
        key = XATTR_PREFIX + name
        if key not in ext:
            raise OSError(errno.ENODATA, name)
        del ext[key]
        meta["extended"] = ext
        self._xattr_store(path, meta)


def mount_filer(
    filer_url: str, mountpoint: str, filer_path: str = "/",
    chunk_size: int = 4 * 1024 * 1024,
) -> int:
    """Blocking mount (the `weed mount` entry point)."""
    from .fuse_ctypes import FUSE

    FUSE(WFS(filer_url, filer_path, chunk_size=chunk_size), mountpoint)
    return 0
