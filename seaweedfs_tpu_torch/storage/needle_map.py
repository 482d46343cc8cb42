"""Needle map: needle id → (offset, size), backed by an append-only .idx.

The reference offers three kinds (in-memory compact map, LevelDB, sorted
file — weed/storage/needle_map.go:13-19). The compact map is a Go
memory-layout optimization (batched arrays + overflow); the idiomatic
Python equivalent is a plain dict, which the interpreter already stores
compactly. A sorted-file map (binary search over `.ecx`-style sorted
entries, zero resident memory) covers the low-memory mode; both share the
append-to-.idx persistence protocol (needle_map_memory.go:57-70).

The port's copy of ``seaweedfs_tpu/storage/needle_map.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from . import idx as idx_mod, types as t


class NeedleValue(NamedTuple):
    offset: int  # byte offset in .dat
    size: int  # stored size field (negative ⇒ deleted)


@dataclass
class MapMetrics:
    file_count: int = 0
    deleted_count: int = 0
    deleted_bytes: int = 0
    file_bytes: int = 0
    maximum_key: int = 0


class NeedleMap:
    """In-memory map with append-only .idx persistence."""

    def __init__(self, idx_path: str | os.PathLike | None = None):
        self._m: dict[int, NeedleValue] = {}
        self.metrics = MapMetrics()
        self._idx_path = os.fspath(idx_path) if idx_path else None
        self._idx_file = None
        if self._idx_path:
            exists = os.path.exists(self._idx_path)
            if exists:
                self._load(self._idx_path)
            # unbuffered: every entry is one write syscall, like the
            # reference's direct File.Write — so readers of the .idx
            # (vacuum makeupDiff, backup) always see appended entries
            self._idx_file = open(self._idx_path, "ab", buffering=0)

    def _load(self, path: str) -> None:
        with open(path, "rb") as f:
            entries = idx_mod.parse_entries(f.read())
        for e in entries:
            key, off, size = int(e["key"]), int(e["offset"]), int(e["size"])
            if t.size_is_valid(size):
                self._set(key, off, size)
            else:
                self._del(key)

    # -- internal state transitions (metrics match needle_map_metric.go) --

    def _set(self, key: int, offset: int, size: int) -> None:
        old = self._m.get(key)
        self._m[key] = NeedleValue(offset, size)
        self.metrics.maximum_key = max(self.metrics.maximum_key, key)
        self.metrics.file_count += 1
        self.metrics.file_bytes += size
        if old is not None and t.size_is_valid(old.size):
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += old.size

    def _del(self, key: int) -> int:
        # Deleted entries stay in the map with negated size so reads
        # distinguish "deleted" from "never existed" (the reference
        # compact map negates Size; volume_read_write.go:294-301).
        old = self._m.get(key)
        if old is not None and t.size_is_valid(old.size):
            self._m[key] = NeedleValue(old.offset, -old.size)
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += old.size
            return old.size
        return 0

    # -- public protocol --------------------------------------------------

    def put(self, key: int, offset: int, size: int) -> None:
        self._set(key, offset, size)
        if self._idx_file:
            self._idx_file.write(t.pack_idx_entry(key, offset, size))

    def get(self, key: int) -> NeedleValue | None:
        return self._m.get(key)

    def delete(self, key: int, offset: int) -> int:
        deleted = self._del(key)
        if self._idx_file:
            self._idx_file.write(
                t.pack_idx_entry(key, offset, t.TOMBSTONE_FILE_SIZE)
            )
        return deleted

    def ascending_visit(self):
        for key in sorted(self._m):
            yield key, self._m[key]

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, key: int) -> bool:
        return key in self._m

    @property
    def content_size(self) -> int:
        return self.metrics.file_bytes

    def flush(self) -> None:
        if self._idx_file:
            self._idx_file.flush()

    def sync(self) -> None:
        if self._idx_file:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    def close(self) -> None:
        if self._idx_file:
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None

    def destroy(self) -> None:
        self.close()
        if self._idx_path and os.path.exists(self._idx_path):
            os.remove(self._idx_path)


class SqliteNeedleMap:
    """Durable WRITABLE needle map with bounded resident memory.

    The reference's LevelDB kind (weed/storage/needle_map_leveldb.go):
    the id→(offset,size) map lives in an on-disk store instead of RAM,
    so a 30 GB volume's multi-million-entry index no longer has to fit
    in memory. Shares the append-to-.idx persistence protocol with the
    in-memory kind (idx stays the source of truth; the db carries a
    replay watermark + prefix fingerprint and rebuilds itself from the
    .idx when missing, stale, or from a different compaction, like
    generateLevelDbFile / levelDbWrite).
    """

    _BATCH_COMMIT = 1024  # ops between commits (crash ⇒ idx replay)

    def __init__(
        self,
        idx_path: str | os.PathLike,
        db_path: str | None = None,
        cache_kb: int = 2048,
    ):
        import sqlite3
        import threading
        import zlib

        self._zlib = zlib
        self._idx_path = os.fspath(idx_path)
        self._db_path = db_path or self._idx_path + ".ldb"
        self._lock = threading.RLock()
        self.metrics = MapMetrics()
        self._dirty_ops = 0
        self._conn = sqlite3.connect(
            self._db_path, check_same_thread=False
        )
        cur = self._conn
        cur.execute("PRAGMA journal_mode=TRUNCATE")
        cur.execute("PRAGMA synchronous=NORMAL")
        cur.execute(f"PRAGMA cache_size=-{cache_kb}")  # KiB cap
        cur.execute(
            "CREATE TABLE IF NOT EXISTS needles("
            "key INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)"
        )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS meta(k TEXT PRIMARY KEY, v)"
        )
        self._replay_idx()
        # unbuffered append handle, same protocol as NeedleMap
        self._idx_file = open(self._idx_path, "ab", buffering=0)

    # -- idx replay ------------------------------------------------------

    def _meta(self, k: str, default=0):
        row = self._conn.execute(
            "SELECT v FROM meta WHERE k=?", (k,)
        ).fetchone()
        return row[0] if row else default

    def _fingerprint(self, length: int) -> int:
        """crc32 of the first `length` idx bytes: detects a REPLACED
        idx (compaction writes a fresh .cpx) whose size could still
        exceed the stored watermark. The region length is recorded
        alongside so appends past it never change the fingerprint
        (a fixed 4 KiB window would defeat watermark-resume for any
        idx that was smaller than the window at close)."""
        try:
            with open(self._idx_path, "rb") as f:
                return self._zlib.crc32(f.read(length))
        except OSError:
            return 0

    _FP_MAX = 4096

    def _replay_idx(self) -> None:
        idx_size = (
            os.path.getsize(self._idx_path)
            if os.path.exists(self._idx_path)
            else 0
        )
        watermark = int(self._meta("idx_offset"))
        fp_len = int(self._meta("idx_fp_len"))
        fp = self._fingerprint(min(fp_len, idx_size))
        if watermark > idx_size or (
            watermark > 0 and fp != self._meta("idx_fp", fp)
        ):
            # truncated or replaced idx: rebuild from scratch
            self._conn.execute("DELETE FROM needles")
            watermark = 0
            self.metrics = MapMetrics()
        else:
            self._load_metrics()
        if watermark >= idx_size:
            self._store_meta(watermark)
            self._conn.commit()
            return
        with open(self._idx_path, "rb") as f:
            f.seek(watermark)
            while True:
                blob = f.read(
                    t.NEEDLE_MAP_ENTRY_SIZE * self._BATCH_COMMIT
                )
                if not blob:
                    break
                entries = idx_mod.parse_entries(blob)
                self._apply_batch(entries)
                watermark += len(blob)
        self._store_meta(watermark)
        self._conn.commit()

    def _apply_batch(self, entries) -> None:
        """Replay one idx batch, maintaining the same metrics the
        memory kind accumulates (incl. overwrite garbage — vacuum's
        garbage-ratio input, needle_map_metric.go)."""
        for e in entries:
            key, off, size = (
                int(e["key"]), int(e["offset"]), int(e["size"]),
            )
            old = self._conn.execute(
                "SELECT size FROM needles WHERE key=?", (key,)
            ).fetchone()
            if t.size_is_valid(size):
                self._conn.execute(
                    "INSERT OR REPLACE INTO needles VALUES(?,?,?)",
                    (key, off, size),
                )
                self.metrics.maximum_key = max(
                    self.metrics.maximum_key, key
                )
                self.metrics.file_count += 1
                self.metrics.file_bytes += size
                if old is not None and t.size_is_valid(old[0]):
                    self.metrics.deleted_count += 1
                    self.metrics.deleted_bytes += old[0]
            else:
                if old is not None and t.size_is_valid(old[0]):
                    self._conn.execute(
                        "UPDATE needles SET size=-abs(size) "
                        "WHERE key=?",
                        (key,),
                    )
                    self.metrics.deleted_count += 1
                    self.metrics.deleted_bytes += old[0]

    def _store_meta(self, watermark: int) -> None:
        fp_len = min(watermark, self._FP_MAX)
        m = self.metrics
        self._conn.executemany(
            "INSERT OR REPLACE INTO meta VALUES(?,?)",
            [
                ("idx_offset", watermark),
                ("idx_fp", self._fingerprint(fp_len)),
                ("idx_fp_len", fp_len),
                ("m_file_count", m.file_count),
                ("m_deleted_count", m.deleted_count),
                ("m_deleted_bytes", m.deleted_bytes),
                ("m_file_bytes", m.file_bytes),
                ("m_max_key", m.maximum_key),
            ],
        )

    def _load_metrics(self) -> None:
        self.metrics = MapMetrics(
            file_count=int(self._meta("m_file_count")),
            deleted_count=int(self._meta("m_deleted_count")),
            deleted_bytes=int(self._meta("m_deleted_bytes")),
            file_bytes=int(self._meta("m_file_bytes")),
            maximum_key=int(self._meta("m_max_key")),
        )

    def _bump_watermark(self, nbytes: int) -> None:
        self._conn.execute(
            "UPDATE meta SET v=v+? WHERE k='idx_offset'", (nbytes,)
        )
        self._dirty_ops += 1
        if self._dirty_ops >= self._BATCH_COMMIT:
            watermark = int(self._meta("idx_offset"))
            self._store_meta(watermark)
            self._conn.commit()
            self._dirty_ops = 0

    # -- public protocol (same as NeedleMap) ----------------------------

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            self._idx_file.write(t.pack_idx_entry(key, offset, size))
            old = self.get(key)
            self._conn.execute(
                "INSERT OR REPLACE INTO needles VALUES(?,?,?)",
                (key, offset, size),
            )
            self._bump_watermark(t.NEEDLE_MAP_ENTRY_SIZE)
            self.metrics.maximum_key = max(
                self.metrics.maximum_key, key
            )
            self.metrics.file_count += 1
            self.metrics.file_bytes += size
            if old is not None and t.size_is_valid(old.size):
                self.metrics.deleted_count += 1
                self.metrics.deleted_bytes += old.size

    def get(self, key: int) -> NeedleValue | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT offset, size FROM needles WHERE key=?", (key,)
            ).fetchone()
        return NeedleValue(row[0], row[1]) if row else None

    def delete(self, key: int, offset: int) -> int:
        with self._lock:
            self._idx_file.write(
                t.pack_idx_entry(key, offset, t.TOMBSTONE_FILE_SIZE)
            )
            old = self.get(key)
            deleted = 0
            if old is not None and t.size_is_valid(old.size):
                self._conn.execute(
                    "UPDATE needles SET size=-abs(size) WHERE key=?",
                    (key,),
                )
                self.metrics.deleted_count += 1
                self.metrics.deleted_bytes += old.size
                deleted = old.size
            self._bump_watermark(t.NEEDLE_MAP_ENTRY_SIZE)
            return deleted

    def ascending_visit(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, offset, size FROM needles ORDER BY key"
            )
            for key, off, size in rows:
                yield key, NeedleValue(off, size)

    def __len__(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM needles"
            ).fetchone()[0]

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    @property
    def content_size(self) -> int:
        return self.metrics.file_bytes

    def flush(self) -> None:
        with self._lock:
            self._store_meta(int(self._meta("idx_offset")))
            self._conn.commit()

    def sync(self) -> None:
        with self._lock:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())
            self._store_meta(int(self._meta("idx_offset")))
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            if self._idx_file:
                self._idx_file.close()
                self._idx_file = None
            if self._conn is not None:
                self._store_meta(int(self._meta("idx_offset")))
                self._conn.commit()
                self._conn.close()
                self._conn = None

    def destroy(self) -> None:
        self.close()
        for p in (self._idx_path, self._db_path):
            if os.path.exists(p):
                os.remove(p)


def new_needle_map(
    idx_path: str | os.PathLike | None, kind: str = "memory"
):
    """Factory over the map kinds (needle_map.go:13-19
    NeedleMapInMemory / NeedleMapLevelDb)."""
    if kind == "memory":
        return NeedleMap(idx_path)
    if kind == "sqlite":
        if idx_path is None:
            raise ValueError("sqlite needle map requires an idx path")
        return SqliteNeedleMap(idx_path)
    raise ValueError(f"unknown needle map kind {kind!r}")


class SortedFileNeedleMap:
    """Read-only map over a needle-id-sorted index (`.ecx`/`.sdx` style):
    zero resident memory, O(log n) binary search per lookup — numpy
    searchsorted over the memory-mapped key column."""

    def __init__(self, path: str | os.PathLike):
        with open(path, "rb") as f:
            self._entries = idx_mod.parse_entries(f.read())
        self._keys = np.ascontiguousarray(self._entries["key"])

    def get(self, key: int) -> NeedleValue | None:
        i = int(np.searchsorted(self._keys, key))
        if i >= len(self._keys) or int(self._keys[i]) != key:
            return None
        e = self._entries[i]
        return NeedleValue(int(e["offset"]), int(e["size"]))

    def __len__(self) -> int:
        return len(self._keys)
