"""Filer core: entry CRUD over a store, event log, chunk GC.

Behavioral model: weed/filer/filer.go:30-105, filer_delete_entry.go,
filer_rename (filer_grpc_server_rename.go), filer_notify.go (the metadata
event log; here an in-memory ring with subscriber callbacks — the
in-process analog of the LogBuffer + SubscribeMetadata stream), and
filerstore_hardlink.go (hardlink-id indirection: the shared inode meta —
attr, chunks, xattrs, link count — lives under one KV key; directory
entries carry only the hardlink id).

The port's copy of ``seaweedfs_tpu/filer/filer.py``.
"""

from __future__ import annotations

import json
import secrets
import threading
import time
from typing import Callable

from .entry import DIR_MODE, Attr, Entry, FileChunk, new_directory_entry
from .filerstore import FilerStore
from .log_buffer import MetaEvent, MetaLogBuffer

__all__ = ["Filer", "MetaEvent"]

HARD_LINK_MARKER = b"hardlink/"  # KV namespace for shared link meta


class Filer:
    def __init__(
        self,
        store: FilerStore,
        delete_chunks_fn: Callable[[list], None] | None = None,
        event_log_size: int = 8192,
        event_log_dir: str | None = None,
    ):
        self.store = store
        self._delete_chunks = delete_chunks_fn or (lambda chunks: None)
        # Persistent, memory-bounded event log (filer_notify.go /
        # log_buffer.go analog): segments on disk when event_log_dir is
        # set, bounded deque tail either way.
        self.meta_log = MetaLogBuffer(
            event_log_dir, mem_events=event_log_size
        )
        self._subscribers: list[Callable[[MetaEvent], None]] = []
        # long-poll seam: /meta/events?wait=true blocks here until the
        # next mutation instead of the subscriber timer-polling
        # (SubscribeMetadata stream analog, filer_grpc_server_sub_meta.go)
        self._event_cond = threading.Condition()
        self._lock = threading.RLock()
        if self.store.find_entry("/") is None:
            self.store.insert_entry(new_directory_entry("/"))

    # -- events ----------------------------------------------------------

    def subscribe(self, fn: Callable[[MetaEvent], None]) -> None:
        self._subscribers.append(fn)

    def events_since(
        self, ts_ns: int, limit: int = 8192
    ) -> list[MetaEvent]:
        return self.meta_log.since(ts_ns, limit)

    def wait_for_events(
        self, ts_ns: int, timeout: float, limit: int = 8192
    ) -> list[MetaEvent]:
        """events_since, blocking up to `timeout` for the first new
        mutation (long-poll half of the push-subscription model)."""
        deadline = time.monotonic() + timeout
        while True:
            events = self.meta_log.since(ts_ns, limit)
            remaining = deadline - time.monotonic()
            if events or remaining <= 0:
                return events
            with self._event_cond:
                if not self.meta_log.since(ts_ns, 1):
                    self._event_cond.wait(min(remaining, 1.0))

    def close(self) -> None:
        self.meta_log.close()
        self.store.close()

    def _notify(
        self, directory: str, old: Entry | None, new: Entry | None
    ) -> None:
        ev = MetaEvent(
            ts_ns=time.time_ns(),
            directory=directory,
            old_entry=old.to_dict() if old else None,
            new_entry=new.to_dict() if new else None,
        )
        self.meta_log.append(ev)
        with self._event_cond:
            self._event_cond.notify_all()
        for fn in self._subscribers:
            try:
                fn(ev)
            except Exception:
                pass

    # -- hardlinks (filerstore_hardlink.go analog) -----------------------

    def _hl_key(self, hlid: str) -> bytes:
        return HARD_LINK_MARKER + hlid.encode()

    def _hl_read(self, hlid: str) -> dict | None:
        raw = self.store.kv_get(self._hl_key(hlid))
        return json.loads(raw) if raw else None

    def _hl_write(self, hlid: str, meta: dict) -> None:
        self.store.kv_put(
            self._hl_key(hlid), json.dumps(meta).encode()
        )

    @staticmethod
    def _hl_meta_from(entry: Entry, nlink: int) -> dict:
        return {
            "nlink": nlink,
            "attr": entry.attr.to_dict(),
            "chunks": [c.to_dict() for c in entry.chunks],
            "extended": entry.extended,
        }

    def _resolve_hardlink(self, entry: Entry) -> Entry:
        """Fill a directory entry from its shared inode meta (the
        reference's FilerStoreWrapper.maybeReadHardLink)."""
        if not entry.hard_link_id:
            return entry
        meta = self._hl_read(entry.hard_link_id)
        if meta is None:
            return entry
        return Entry(
            full_path=entry.full_path,
            attr=Attr.from_dict(meta["attr"]),
            chunks=[
                FileChunk.from_dict(c) for c in meta["chunks"]
            ],
            extended=meta.get("extended", {}),
            hard_link_id=entry.hard_link_id,
            hard_link_counter=meta.get("nlink", 1),
        )

    def _hl_unlink(self, hlid: str) -> list[FileChunk]:
        """Drop one name (caller holds self._lock). Returns the chunks
        to GC — only non-empty at zero links; the caller deletes them
        AFTER releasing the lock (chunk deletes are HTTP round-trips
        to volume servers and must not serialize the filer)."""
        meta = self._hl_read(hlid)
        if meta is None:
            return []
        meta["nlink"] -= 1
        if meta["nlink"] <= 0:
            self.store.kv_delete(self._hl_key(hlid))
            return [FileChunk.from_dict(c) for c in meta["chunks"]]
        self._hl_write(hlid, meta)
        return []

    def _unlink_name(self, entry: Entry) -> list[FileChunk]:
        """Drop one directory name: a hardlinked name decrements the
        shared count with the name delete atomic under the lock (a
        racing link() must never see count-decremented-but-name-alive
        or vice versa); a plain name surrenders its chunks. Either
        way the returned chunks are for the CALLER to GC after all
        locks are released."""
        if entry.hard_link_id:
            with self._lock:
                garbage = self._hl_unlink(entry.hard_link_id)
                self.store.delete_entry(entry.full_path)
            return garbage
        self.store.delete_entry(entry.full_path)
        return list(entry.chunks)

    def link(self, src: str, dst: str) -> Entry:
        """Hardlink: dst becomes another name for src's inode
        (weed/filesys/dir_link.go Link + filerstore_hardlink.go)."""
        with self._lock:
            src = src.rstrip("/") or "/"
            dst = dst.rstrip("/")
            raw = self.store.find_entry(src)
            if raw is None:
                raise FileNotFoundError(src)
            if raw.is_directory:
                raise IsADirectoryError(src)
            if self.store.find_entry(dst) is not None:
                raise FileExistsError(dst)
            src_converted = None
            if raw.hard_link_id:
                hlid = raw.hard_link_id
                meta = self._hl_read(hlid)
                if meta is None:
                    if not raw.chunks:
                        # pointer whose meta was just unlinked by a
                        # racing delete: rebuilding from the chunkless
                        # pointer would manufacture an empty inode
                        raise FileNotFoundError(src)
                    # legacy non-stripped entry: rebuild its meta
                    meta = self._hl_meta_from(raw, nlink=1)
            else:
                # first link: move the inode meta into the shared KV
                # record and turn the original entry into a pointer
                hlid = secrets.token_hex(16)
                meta = self._hl_meta_from(raw, nlink=1)
                pointer = Entry(
                    full_path=raw.full_path,
                    attr=raw.attr,
                    hard_link_id=hlid,
                )
                self.store.update_entry(pointer)
                src_converted = (raw, pointer)
            meta["nlink"] += 1
            self._hl_write(hlid, meta)
            self._ensure_parents(
                dst.rsplit("/", 1)[0] or "/"
            )
            link_entry = Entry(
                full_path=dst,
                attr=Attr.from_dict(meta["attr"]),
                hard_link_id=hlid,
            )
            self.store.insert_entry(link_entry)
        # events carry RESOLVED entries (full attr + chunks): meta
        # subscribers and cross-filer sync replicate content, not
        # chunkless pointers into a KV namespace they can't see
        resolved = self._resolve_hardlink(link_entry)
        if src_converted is not None:
            raw, pointer = src_converted
            self._notify(
                pointer.parent, raw, self._resolve_hardlink(pointer)
            )
        self._notify(resolved.parent, None, resolved)
        return resolved

    # -- CRUD ------------------------------------------------------------

    def create_entry(self, entry: Entry) -> None:
        self._ensure_parents(entry.parent)
        old = self.store.find_entry(entry.full_path)
        hlid = entry.hard_link_id or (
            old.hard_link_id if old else ""
        )
        if hlid:
            if self._hl_update(entry, old, hlid):
                return
            # the shared meta is gone (last link already dropped):
            # store a plain file, not a dangling pointer
            entry.hard_link_id = ""
        if old and not old.is_directory and old.chunks:
            # overwritten file: old chunks become garbage
            surviving = {c.file_id for c in entry.chunks}
            garbage = [
                c for c in old.chunks if c.file_id not in surviving
            ]
            if garbage:
                self._delete_chunks(garbage)
        self.store.insert_entry(entry)
        self._notify(entry.parent, old, entry)

    def _hl_update(
        self, entry: Entry, old: Entry | None, hlid: str
    ) -> bool:
        """Write through any name of a hardlinked inode: update the
        SHARED meta (under the filer lock — the nlink read-modify-write
        must not race link()/unlink on another thread) so every name
        sees the new content. Returns False if the hardlink meta is
        gone (caller falls through to the plain-entry path)."""
        with self._lock:
            meta = self._hl_read(hlid)
            if meta is None:
                return False
            old_chunks = [
                FileChunk.from_dict(c) for c in meta["chunks"]
            ]
            surviving = {c.file_id for c in entry.chunks}
            garbage = [
                c for c in old_chunks if c.file_id not in surviving
            ]
            meta["attr"] = entry.attr.to_dict()
            meta["chunks"] = [c.to_dict() for c in entry.chunks]
            meta["extended"] = entry.extended
            self._hl_write(hlid, meta)
            pointer = None
            if old is not None:
                pointer = Entry(
                    full_path=entry.full_path,
                    attr=entry.attr,
                    hard_link_id=hlid,
                )
                self.store.insert_entry(pointer)
            # old is None = write-after-unlink: the fd still reaches
            # the inode (other names see the content), but the deleted
            # NAME must not be resurrected as a directory entry
        if garbage:
            self._delete_chunks(garbage)
        if pointer is not None:
            # resolved form in the event (see link()): subscribers and
            # sync peers need the content, not the pointer
            resolved = Entry(
                full_path=entry.full_path,
                attr=entry.attr,
                chunks=entry.chunks,
                extended=entry.extended,
                hard_link_id=hlid,
                hard_link_counter=meta.get("nlink", 1),
            )
            self._notify(entry.parent, old, resolved)
        return True

    def update_entry(self, entry: Entry) -> None:
        old = self.store.find_entry(entry.full_path)
        hlid = entry.hard_link_id or (
            old.hard_link_id if old else ""
        )
        if hlid and self._hl_update(entry, old, hlid):
            return
        self.store.update_entry(entry)
        self._notify(entry.parent, old, entry)

    def _ensure_parents(self, dir_path: str) -> None:
        if dir_path in ("", "/"):
            return
        if self.store.find_entry(dir_path) is not None:
            return
        parent = dir_path.rstrip("/").rsplit("/", 1)[0] or "/"
        self._ensure_parents(parent)
        d = new_directory_entry(dir_path)
        self.store.insert_entry(d)
        self._notify(parent, None, d)

    def find_entry(self, path: str) -> Entry | None:
        if path != "/":
            path = path.rstrip("/")
        entry = self.store.find_entry(path or "/")
        return self._resolve_hardlink(entry) if entry else None

    def list_entries(
        self,
        dir_path: str,
        start_file: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        return [
            self._resolve_hardlink(e)
            for e in self.store.list_directory_entries(
                dir_path, start_file, inclusive, limit, prefix
            )
        ]

    def delete_entry(
        self,
        path: str,
        recursive: bool = False,
        ignore_recursive_error: bool = False,
        gc_chunks: bool = True,
    ) -> None:
        """Delete `path` (recursively when asked).

        `gc_chunks=False` removes the metadata but leaves the volume
        chunks alive — the cross-shard rename source-side delete
        (filer/sharding): the destination shard's entry still
        references those chunks, so GC-ing them here would destroy
        the just-moved file's data."""
        if path != "/":
            path = path.rstrip("/")
        # raw (unresolved) entry: a hardlinked name must decrement the
        # shared link count, NOT GC the inode's chunks directly
        entry = self.store.find_entry(path or "/")
        if entry is None:
            return
        # the delete event carries the RESOLVED form (full attr +
        # chunks), matching link()/_hl_update: replication sinks and
        # meta subscribers must see chunk-resolved content, not a
        # chunkless pointer into a KV namespace they can't read — and
        # the shared meta may be GONE right after _unlink_name drops
        # the last link, so resolve BEFORE unlinking
        notify_old = (
            self._resolve_hardlink(entry)
            if entry.hard_link_id else entry
        )
        if entry.is_directory:
            children = self.list_entries(path, limit=2)
            if children and not recursive:
                raise IsADirectoryError(
                    f"{path} is a non-empty folder"
                )
            # Bucket roots take the wholesale path (reference bucket
            # deletion): the walk GCs chunks and emits events but
            # leaves rows alone, then ONE delete_folder_children call
            # drops them — a DROP TABLE on the sqlite store, not N
            # row deletes. Other directories delete rows during the
            # walk so a crash mid-delete leaks chunks, never dangling
            # metadata pointing at freed chunks.
            is_bucket = (
                path.startswith("/buckets/")
                and path.count("/") == 2
            )
            self._delete_children(
                path, defer_rows=is_bucket, gc_chunks=gc_chunks
            )
            if is_bucket:
                self.store.delete_folder_children(path)
            self.store.delete_entry(entry.full_path)
        else:
            garbage = self._unlink_name(entry)
            if garbage and gc_chunks:
                self._delete_chunks(garbage)
        self._notify(entry.parent, notify_old, None)

    def _delete_children(
        self, dir_path: str, defer_rows: bool = False,
        gc_chunks: bool = True,
    ) -> None:
        """Recursive delete walk: chunk GC, hardlink accounting, meta
        events; row deletion happens inline unless the caller (bucket
        fast path) drops them wholesale afterwards."""
        last = ""
        while True:
            children = self.store.list_directory_entries(
                dir_path, last, False, 512, ""
            )
            if not children:
                break
            for child in children:
                notify_child = child
                if child.is_directory:
                    self._delete_children(
                        child.full_path, defer_rows=defer_rows,
                        gc_chunks=gc_chunks,
                    )
                    if not defer_rows:
                        self.store.delete_entry(child.full_path)
                elif child.hard_link_id:
                    # resolved form in the event (see delete_entry):
                    # the shared meta disappears at zero links
                    notify_child = self._resolve_hardlink(child)
                    with self._lock:
                        garbage = self._hl_unlink(
                            child.hard_link_id
                        )
                        if not defer_rows:
                            self.store.delete_entry(
                                child.full_path
                            )
                    if garbage and gc_chunks:
                        self._delete_chunks(garbage)
                else:
                    if not defer_rows:
                        self.store.delete_entry(child.full_path)
                    if child.chunks and gc_chunks:
                        self._delete_chunks(child.chunks)
                self._notify(dir_path, notify_child, None)
            last = children[-1].name

    def rename(self, old_path: str, new_path: str) -> None:
        """Move an entry (and its subtree) — filer_grpc_server_rename.go.

        The whole move runs inside ONE store transaction (the reference
        wraps MoveEntry in store.BeginTransaction), so a crash mid-move
        can never leave the tree half-renamed on a transactional
        store."""
        # meta events buffer until the commit: a rollback must not
        # have pushed phantom half-rename events to subscribers.
        # Chunk GC for overwritten targets is deferred the same way —
        # a rolled-back rename must not have deleted live chunks.
        events: list[tuple[str, Entry | None, Entry | None]] = []
        garbage: list[FileChunk] = []
        # filer-lock BEFORE store-lock, always: begin_transaction holds
        # the store RLock until commit, and _unlink_name (hardlinked
        # rename target) takes self._lock — taken in the other order, a
        # concurrent link()/delete (filer-lock → store-lock) deadlocks
        # both threads with all locks held (ADVICE r5, weedcheck
        # lock-order-cycle)
        with self._lock:
            self.store.begin_transaction()
            try:
                self._rename_locked(
                    old_path, new_path, events, garbage
                )
            except Exception:
                self.store.rollback_transaction()
                raise
            self.store.commit_transaction()
        if garbage:
            self._delete_chunks(garbage)
        for directory, old, new in events:
            self._notify(directory, old, new)

    def _rename_locked(
        self,
        old_path: str,
        new_path: str,
        events: list,
        garbage: list,
    ) -> None:
        # raw entry: a hardlinked name moves as a pointer — the shared
        # inode meta (and the other names) stay untouched
        entry = self.store.find_entry(
            (old_path if old_path == "/" else old_path.rstrip("/"))
            or "/"
        )
        if entry is None:
            raise FileNotFoundError(old_path)
        self._ensure_parents(
            new_path.rstrip("/").rsplit("/", 1)[0] or "/"
        )
        # an overwritten rename target is one dropped name: a
        # hardlinked target decrements its inode's link count, a plain
        # target queues its chunks for post-commit GC
        target = self.store.find_entry(new_path.rstrip("/") or "/")
        if target is not None and not target.is_directory:
            garbage.extend(self._unlink_name(target))
        if entry.is_directory:
            children = self.store.list_directory_entries(
                old_path, "", False, 100000, ""
            )
            for child in list(children):
                self._rename_locked(
                    child.full_path,
                    new_path.rstrip("/") + "/" + child.name,
                    events,
                    garbage,
                )
        moved = Entry(
            full_path=new_path,
            attr=entry.attr,
            chunks=entry.chunks,
            extended=entry.extended,
            hard_link_id=entry.hard_link_id,
        )
        self.store.insert_entry(moved)
        self.store.delete_entry(old_path)
        events.append((entry.parent, entry, None))
        events.append((moved.parent, None, moved))

    def mkdir(self, path: str, mode: int = DIR_MODE) -> Entry:
        self._ensure_parents(path.rstrip("/").rsplit("/", 1)[0] or "/")
        e = self.find_entry(path)
        if e is not None:
            return e
        d = Entry(full_path=path.rstrip("/"), attr=Attr(mode=mode))
        self.store.insert_entry(d)
        self._notify(d.parent, None, d)
        return d
