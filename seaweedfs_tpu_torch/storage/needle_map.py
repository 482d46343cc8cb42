"""Needle map: needle id → (offset, size), backed by an append-only .idx.

The reference offers three kinds (in-memory compact map, LevelDB, sorted
file — weed/storage/needle_map.go:13-19). The compact map is a Go
memory-layout optimization (batched arrays + overflow); the idiomatic
Python equivalent is a plain dict, which the interpreter already stores
compactly. A sorted-file map (binary search over `.ecx`-style sorted
entries, zero resident memory) covers the low-memory mode; both share the
append-to-.idx persistence protocol (needle_map_memory.go:57-70).

The port's copy of ``seaweedfs_tpu/storage/needle_map.py`` without its
LevelDB-analog ``SqliteNeedleMap``: ``new_needle_map(kind="sqlite")``
raises until it is ported.
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


def new_needle_map(
    idx_path: str | os.PathLike | None, kind: str = "memory"
):
    """Factory over the map kinds (needle_map.go:13-19
    NeedleMapInMemory / NeedleMapLevelDb)."""
    if kind == "memory":
        return NeedleMap(idx_path)
    if kind == "sqlite":
        raise ValueError(
            "the sqlite needle map is not ported yet (ROADMAP queue 1: "
            "the remaining host-only planes)"
        )
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
