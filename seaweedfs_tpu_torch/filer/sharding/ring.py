"""ShardMap + FilerRing: deterministic namespace partitioning.

Behavioral model: the reference's bucket partitioning (``filer.sync``
per-bucket stores, weed/filer/filer.go bucket-aware store routing)
generalized to N shards: the routing key of a path is its top-level
namespace prefix — the bucket name for ``/buckets/<b>/...`` paths,
else the first path segment — hashed with crc32 onto a fixed shard
count. A whole subtree shares its routing key, so every entry of a
bucket (or of any top-level directory) lives on exactly one shard and
single-shard operations keep the filer's native transactional
semantics. Only the two namespace roots whose CHILDREN span routing
keys — ``/`` and ``/buckets`` — fan out: listing merges sorted pages
from every shard, recursive delete deletes on every shard.

Cross-shard rename is create-then-delete with a tombstone guard: a
metadata-only tombstone entry under ``/.system/renames/`` on the
SOURCE shard records the intent before the copy starts, and is only
cleared after the source subtree is deleted. ``recover_renames()``
replays interrupted renames after a shard kill so no entry is ever
lost or duplicated — the same crash-recovery discipline as the broker's
offset recovery.

The ring lock guards only the cached shard map — never held across an
HTTP call (the MasterRing discipline). Shard metric labels are
bounded: ``shard0..shardN`` (N <= 64), never paths.

The port's copy of ``seaweedfs_tpu/filer/sharding/ring.py``.
"""

from __future__ import annotations

import threading
import urllib.parse
import zlib

from ...stats.metrics import (
    FILER_CROSS_RENAMES,
    FILER_RING_RESOLVES,
)
from ...util import glog, http
from ...util import retry as retry_mod

# fan-out roots: directories whose children span routing keys
_FANOUT_DIRS = ("/", "/buckets")

# tombstone directory for interrupted cross-shard renames; lives on
# the SOURCE shard of each rename, scanned per-shard during recovery
RENAME_DIR = "/.system/renames"
_X_FROM = "seaweed-rename-from"
_X_TO = "seaweed-rename-to"

MAX_SHARDS = 64  # keeps per-shard metric label sets bounded


def routing_key(path: str) -> str | None:
    """The namespace prefix a path hashes on, or None for the fan-out
    roots themselves (``/`` and ``/buckets``)."""
    segs = [s for s in path.split("/") if s]
    if not segs:
        return None
    if segs[0] == "buckets":
        if len(segs) < 2:
            return None
        return "buckets/" + segs[1]
    return segs[0]


class ShardMap:
    """A fixed, ordered list of shard URLs plus the hash that routes
    a path to one of them. Shard identity is POSITIONAL — the map is
    only valid while every client agrees on the same ordered list, so
    re-resolution never changes the count (the hash space)."""

    def __init__(self, urls):
        if isinstance(urls, str):
            urls = [urls]
        urls = [u.rstrip("/") for u in urls if u]
        if not urls:
            raise ValueError("empty filer shard map")
        if len(urls) > MAX_SHARDS:
            raise ValueError(
                f"filer shard count {len(urls)} exceeds {MAX_SHARDS}"
            )
        self.urls: list[str] = list(urls)

    def __len__(self) -> int:
        return len(self.urls)

    def shard_of(self, path: str) -> int:
        key = routing_key(urllib.parse.unquote(path))
        if key is None:
            return 0  # key-less paths home to shard 0
        return zlib.crc32(key.encode()) % len(self.urls)

    def url_for(self, path: str) -> str:
        return self.urls[self.shard_of(path)]

    def fans_out(self, dir_path: str) -> bool:
        """True when listing/deleting this directory must touch every
        shard: its children hash to different shards."""
        if len(self.urls) == 1:
            return False
        norm = "/" + urllib.parse.unquote(dir_path).strip("/")
        return norm in _FANOUT_DIRS


class FilerRing:
    """Shard-aware client router over a filer tier.

    Accepts one URL (degenerate single-shard ring — byte-identical
    routing to the bare URL) or an ordered shard list. All requests
    ride ``util/retry.Policy``; a transport-dead shard triggers one
    shard-map re-resolve from the master (``FilerShards`` beside
    ``/cluster/status``) before the error surfaces, the same way
    ``MasterRing`` re-finds leaders.
    """

    def __init__(self, urls, masters=None,
                 read_retry: "retry_mod.Policy" = retry_mod.LOOKUP,
                 write_retry: "retry_mod.Policy" = retry_mod.DEFAULT):
        self._map = ShardMap(urls)
        self.masters = masters
        self.read_retry = read_retry
        self.write_retry = write_retry
        # guards only the cached map pointer — never held across HTTP
        self._lock = threading.Lock()

    # -- shard map -------------------------------------------------------

    @property
    def urls(self) -> list[str]:
        with self._lock:
            return list(self._map.urls)

    @property
    def primary(self) -> str:
        with self._lock:
            return self._map.urls[0]

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def shard_of(self, path: str) -> int:
        with self._lock:
            return self._map.shard_of(path)

    def url_for(self, path: str) -> str:
        with self._lock:
            return self._map.url_for(path)

    def fans_out(self, dir_path: str) -> bool:
        with self._lock:
            return self._map.fans_out(dir_path)

    @classmethod
    def from_master(cls, master, **kw) -> "FilerRing":
        urls = cls.resolve_shards(master)
        if not urls:
            raise ValueError("master published no filer shards")
        return cls(urls, masters=master, **kw)

    @staticmethod
    def resolve_shards(master) -> list[str]:
        """The ordered shard list the master tier publishes, or []
        when unreachable / not published."""
        from ...operation import masters as masters_mod

        ring = masters_mod.ring_of(master)
        try:
            st = ring.get_json("/cluster/status")
        except http.HttpError:
            return []
        return [u for u in (st.get("FilerShards") or []) if u]

    def reresolve(self) -> bool:
        """Re-read the shard map from the master tier. The shard COUNT
        is the hash space and must not drift — a published list of a
        different length is ignored."""
        if self.masters is None:
            FILER_RING_RESOLVES.inc("no_masters")
            return False
        urls = self.resolve_shards(self.masters)
        with self._lock:
            if len(urls) != len(self._map):
                FILER_RING_RESOLVES.inc(
                    "unavailable" if not urls else "count_mismatch"
                )
                return False
            if urls == self._map.urls:
                FILER_RING_RESOLVES.inc("unchanged")
                return False
            self._map = ShardMap(urls)
        FILER_RING_RESOLVES.inc("refreshed")
        glog.V(1).infof("filer ring re-resolved: %s", urls)
        return True

    # -- routed requests -------------------------------------------------

    def request(self, method: str, path: str, body=None, headers=None,
                qs: str = "", timeout: float = 30.0,
                retry: "retry_mod.Policy | None" = None) -> bytes:
        """One routed request; `path` is appended to the owning
        shard's base URL exactly as call sites appended it to the bare
        filer URL. A transport-dead shard (status 0) triggers one
        shard-map re-resolve before the error surfaces."""
        pol = retry if retry is not None else (
            self.read_retry if method in ("GET", "HEAD")
            else self.write_retry
        )
        url = self.url_for(path)
        try:
            return http.request(
                method, f"{url}{path}{qs}", body, headers,
                timeout=timeout, retry=pol,
            )
        except http.HttpError as e:
            if e.status == 0 and self.reresolve():
                return http.request(
                    method, f"{self.url_for(path)}{path}{qs}", body,
                    headers, timeout=timeout, retry=pol,
                )
            raise

    def get_json(self, path: str, qs: str = "",
                 timeout: float = 30.0) -> dict:
        import json

        return json.loads(
            self.request("GET", path, qs=qs, timeout=timeout)
        )

    def get_meta(self, path: str) -> dict | None:
        """The raw entry dict (``?meta=true``), or None when absent."""
        return self._get_meta_url(self.url_for(path), path)

    def _get_meta_url(self, base: str, path: str) -> dict | None:
        import json

        # logical path: wire-quote (see _delete_url)
        try:
            return json.loads(http.request(
                "GET",
                f"{base}{urllib.parse.quote(path)}?meta=true",
                retry=self.read_retry,
            ))
        except http.HttpError as e:
            if e.status == 404:
                return None
            raise

    # -- cross-shard list / delete ---------------------------------------

    def list_page(self, dir_path: str, last: str = "",
                  limit: int = 100) -> list[dict]:
        """One listing page. Single-shard directories page natively;
        fan-out roots merge one page from EVERY shard, de-duplicated
        by name (a directory implicitly created on several shards is
        one logical entry) and re-sorted, so pagination by
        lastFileName stays correct across shards."""
        qs = (
            f"/?limit={limit}"
            f"&lastFileName={urllib.parse.quote(last)}"
        )
        clean = dir_path.rstrip("/") or "/"
        if not self.fans_out(clean):
            out = self.get_json(clean, qs=qs)
            return out.get("Entries") or []
        merged: dict[str, dict] = {}
        for base in self.urls:
            try:
                out = http.get_json(
                    f"{base}{clean.rstrip('/')}{qs}",
                    retry=self.read_retry,
                )
            except http.HttpError as e:
                if e.status == 404:
                    continue  # this shard never saw the directory
                raise
            for e in out.get("Entries") or []:
                name = e["FullPath"].rstrip("/").rsplit("/", 1)[-1]
                merged.setdefault(name, e)
        ordered = sorted(
            merged.items(), key=lambda kv: kv[0]
        )
        return [e for _n, e in ordered[:limit]]

    def list_all(self, dir_path: str, page: int = 1000) -> list[dict]:
        """Every entry of a directory, following pagination (the
        ring-aware form of ``http.list_filer_dir``)."""
        entries: list[dict] = []
        last = ""
        while True:
            batch = self.list_page(dir_path, last=last, limit=page)
            if not batch:
                break
            entries.extend(batch)
            last = batch[-1]["FullPath"].rstrip("/").rsplit("/", 1)[-1]
            if len(batch) < page:
                break
        return entries

    def delete(self, path: str, recursive: bool = False,
               ignore_missing: bool = True) -> None:
        """Routed delete; recursive delete of a fan-out root deletes
        the subtree on EVERY shard."""
        qs = "?recursive=true" if recursive else ""
        if recursive and self.fans_out(path):
            for base in self.urls:
                self._delete_url(base, path, qs=qs,
                                 ignore_missing=True)
            return
        try:
            self.request("DELETE", path, qs=qs)
        except http.HttpError as e:
            if not (ignore_missing and e.status == 404):
                raise

    def _delete_url(self, base: str, path: str, qs: str = "",
                    ignore_missing: bool = True) -> None:
        # `path` is a LOGICAL path: wire-quote it so a literal `%` in
        # an entry name (tombstones encode the renamed path into their
        # name) survives the server-side unquote
        try:
            http.request(
                "DELETE",
                f"{base}{urllib.parse.quote(path)}{qs}",
                retry=self.write_retry,
            )
        except http.HttpError as e:
            if not (ignore_missing and e.status == 404):
                raise

    # -- cross-shard rename ----------------------------------------------

    def rename(self, old: str, new: str) -> None:
        """Rename; same-shard renames keep the filer's native
        transactional ``mv.from``; cross-shard renames are
        create-then-delete guarded by a source-shard tombstone."""
        old = "/" + urllib.parse.unquote(old).strip("/")
        new = "/" + urllib.parse.unquote(new).strip("/")
        so, sn = self.shard_of(old), self.shard_of(new)
        if so == sn:
            self.request(
                "POST", new,
                qs="?mv.from="
                + urllib.parse.quote(old, safe=""),
            )
            return
        self._rename_across(self.urls[so], self.urls[sn], old, new)

    def _rename_across(self, src: str, dst: str, old: str,
                       new: str) -> None:
        tomb = self._tombstone_path(old)
        # 1. durable intent on the source shard BEFORE any mutation:
        #    a kill anywhere past this point is replayable
        self._put_entry(src, tomb, {
            "full_path": tomb,
            "extended": {_X_FROM: old, _X_TO: new},
        })
        meta = self._get_meta_url(src, old)
        if meta is None:
            # lost a race with a concurrent delete: nothing to move
            self._delete_url(src, tomb)
            raise http.HttpError(404, b"rename source not found")
        try:
            # 2. create on the destination shard (chunk lists move as
            #    metadata — no data copy), 3. delete the source
            self._copy_tree(src, dst, old, new, meta)
            # gc=false: the destination entry owns the chunks now —
            # a plain delete here would GC the data out from under it
            self._delete_url(
                src, old, qs="?recursive=true&gc=false"
            )
            # 4. intent fulfilled: clear the guard
            self._delete_url(src, tomb)
        except http.HttpError:
            FILER_CROSS_RENAMES.inc("interrupted")
            raise
        FILER_CROSS_RENAMES.inc("completed")

    @staticmethod
    def _tombstone_path(old: str) -> str:
        return (
            f"{RENAME_DIR}/"
            + urllib.parse.quote(old, safe="")
        )

    def _put_entry(self, base: str, path: str, entry: dict) -> None:
        import json

        entry = dict(entry)
        entry["full_path"] = path
        http.request(
            "POST",
            f"{base}{urllib.parse.quote(path)}?entry=true",
            json.dumps(entry).encode(),
            {"Content-Type": "application/json"},
            retry=self.write_retry,
        )

    def _copy_tree(self, src: str, dst: str, old: str, new: str,
                   meta: dict) -> None:
        """Recreate old's entry (and, for directories, its whole
        subtree — which shares old's routing key, so it moves shard
        wholesale) under new on the destination shard."""
        self._put_entry(dst, new, meta)
        if not (meta.get("attr") or {}).get("mode", 0) & 0o40000:
            return
        for child in http.list_filer_dir(
            src, old, retry=self.read_retry
        ):
            name = child["FullPath"].rstrip("/").rsplit("/", 1)[-1]
            cmeta = self._get_meta_url(src, f"{old}/{name}")
            if cmeta is None:
                continue  # deleted underneath us: nothing to move
            self._copy_tree(
                src, dst, f"{old}/{name}", f"{new}/{name}", cmeta
            )

    def recover_renames(self) -> int:
        """Replay interrupted cross-shard renames: scan every shard's
        tombstone directory and roll each intent FORWARD (redo the
        copy if the destination is missing, then delete the source).
        Idempotent; returns the number of tombstones cleared."""
        recovered = 0
        for src in self.urls:
            try:
                tombs = http.list_filer_dir(
                    src, RENAME_DIR, retry=self.read_retry
                )
            except http.HttpError:
                continue  # shard down or no tombstone dir: next
            for t in tombs:
                ext = t.get("Extended") or {}
                old, new = ext.get(_X_FROM), ext.get(_X_TO)
                tomb = (
                    f"{RENAME_DIR}/"
                    + t["FullPath"].rstrip("/").rsplit("/", 1)[-1]
                )
                if old and new:
                    meta = self._get_meta_url(src, old)
                    if meta is not None:
                        dst = self.urls[self.shard_of(new)]
                        if self._get_meta_url(dst, new) is None:
                            self._copy_tree(src, dst, old, new, meta)
                        self._delete_url(
                            src, old,
                            qs="?recursive=true&gc=false",
                        )
                self._delete_url(src, tomb)
                FILER_CROSS_RENAMES.inc("recovered")
                recovered += 1
        if recovered:
            glog.V(1).infof(
                "filer ring: recovered %d interrupted renames",
                recovered,
            )
        return recovered


def ring_of(filer) -> FilerRing:
    """Coerce a filer address — one URL, an ordered shard list, or an
    existing ring — into a FilerRing (the `masters.ring_of` analog)."""
    if isinstance(filer, FilerRing):
        return filer
    return FilerRing(filer)


def primary_url(filer) -> str:
    """The primary (shard-0) URL of any filer address form — for
    consumers that need one plain URL (e.g. the broker)."""
    if isinstance(filer, FilerRing):
        return filer.primary
    if isinstance(filer, str):
        return filer.rstrip("/")
    return ShardMap(filer).urls[0]
