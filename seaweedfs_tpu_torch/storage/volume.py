"""Volume: one append-only .dat blob log + its .idx needle map.

Behavioral model: weed/storage/volume.go:21-63, volume_read_write.go,
volume_loading.go, volume_checking.go, volume_vacuum.go. Single-writer
append discipline is enforced with an RLock (the reference's
dataFileAccessLock); reads are positional pread-style so they don't
disturb the append head.

The port's copy of ``seaweedfs_tpu/storage/volume.py``. It stamps
``time.time_ns()`` into every appended record, as the reference does, so
two volumes are byte-identical only under one clock. One difference: a
read takes its needle-map lookup and its ``pread`` inside a gate that
the vacuum commit's swap and ``close()`` take alone (``_ReadGate``), so
a read never parses one generation's offset in another's ``.dat``; and
a closed volume raises ``VolumeClosedError`` where the reference's
raises whatever its closed file gives.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from . import needle as needle_mod
from . import needle_map as nm_mod
from . import super_block as sb_mod
from . import types as t
from .file_id import FileId


class NotFoundError(KeyError):
    pass


class DeletedError(KeyError):
    pass


class VolumeReadOnlyError(RuntimeError):
    pass


class VolumeClosedError(RuntimeError):
    """The volume was closed (unmounted, deleted, or replaced by a tier
    move) between a caller's lookup and its read or stat."""


class _ReadGate:
    """Shared by reads, taken alone by a swap of the volume's files.

    A read holds it from its needle-map lookup through its ``pread``, so
    both come from one generation of ``(needle map, .dat)``; any number
    of reads share it, and none waits for an append. A vacuum commit's
    swap and ``close()`` take it alone, after the reads in flight end.
    Only a holder of the volume's ``_lock`` takes it alone, so a writer
    that reads under ``_lock`` (the dedupe check) never waits for one."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0  # guarded-by: self._cond
        self._alone = False  # guarded-by: self._cond

    @contextmanager
    def shared(self):
        with self._cond:
            while self._alone:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def alone(self):
        with self._cond:
            self._alone = True
            while self._readers:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


@dataclass
class VolumeStat:
    file_count: int = 0
    deleted_count: int = 0
    deleted_bytes: int = 0
    size: int = 0


class Volume:
    def __init__(
        self,
        dirname: str | os.PathLike,
        collection: str,
        vid: int,
        replica_placement: t.ReplicaPlacement | None = None,
        ttl: t.TTL | None = None,
        version: int = t.CURRENT_VERSION,
        readonly: bool = False,
        needle_map_kind: str = "memory",
    ):
        self.dir = os.fspath(dirname)
        self.collection = collection
        self.id = vid
        self.readonly = readonly
        self.needle_map_kind = needle_map_kind
        self.last_io_error: Exception | None = None
        self.last_append_at_ns = 0
        self.is_compacting = False
        self.closed = False
        # appends, deletes, stats, the vacuum commit and close
        self._lock = threading.RLock()
        # reads against the commit's swap and close (_ReadGate)
        self._gate = _ReadGate()
        self.last_compact_index_offset = 0
        self.last_compact_revision = 0

        from . import backend as backend_mod

        dat_path = self.data_file_name
        self.remote_backend = None
        vif = backend_mod.load_volume_info(self.base_file_name)
        # offset-width guard (both directions — see
        # backend.check_volume_offset_width)
        if os.path.exists(dat_path) or "remote" in vif:
            backend_mod.check_volume_offset_width(
                self.base_file_name, f"volume {vid}"
            )
        if remote := vif.get("remote"):
            # tiered volume: .dat lives behind a remote backend (HTTP
            # Range server or a sigv4-signed S3 object); remote volumes
            # are readonly (backend/s3_backend semantics)
            self.remote_backend = backend_mod.remote_backend_from_vif(
                remote
            )
            head = self.remote_backend.read_at(
                0, sb_mod.SUPER_BLOCK_SIZE
            )
            self.super_block = sb_mod.SuperBlock.from_bytes(head)
            self.readonly = True
            self._dat = None
            self.nm = nm_mod.new_needle_map(
                self.index_file_name, self.needle_map_kind
            )
            return
        if os.path.exists(dat_path):
            with open(dat_path, "rb") as f:
                head = f.read(sb_mod.SUPER_BLOCK_SIZE + 0xFFFF)
            self.super_block = sb_mod.SuperBlock.from_bytes(head)
        else:
            self.super_block = sb_mod.SuperBlock(
                version=version,
                replica_placement=replica_placement
                or t.ReplicaPlacement(),
                ttl=ttl or t.TTL(),
            )
            with open(dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
            # stamp the width so a differently-configured process
            # refuses to open this volume instead of misparsing
            backend_mod.save_volume_info(
                self.base_file_name,
                {**vif, "offset_size": t.OFFSET_SIZE},
            )
        self._dat = open(dat_path, "r+b")
        self.nm = nm_mod.new_needle_map(
            self.index_file_name, self.needle_map_kind
        )
        self.check_integrity()

    # -- naming ----------------------------------------------------------

    @property
    def base_file_name(self) -> str:
        name = f"{self.id}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(self.dir, name)

    @property
    def data_file_name(self) -> str:
        return self.base_file_name + ".dat"

    @property
    def index_file_name(self) -> str:
        return self.base_file_name + ".idx"

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self) -> t.TTL:
        return self.super_block.ttl

    # -- size / stats ----------------------------------------------------

    def data_file_size(self) -> int:
        if self.remote_backend is not None:
            self._check_open()
            return self.remote_backend.size()
        # under the volume lock: commit_compact swaps self._dat while
        # holding it, and a lock-free fstat can land on the closed
        # handle mid-swap (heartbeat stat racing a background vacuum)
        with self._lock:
            self._check_open()
            return os.fstat(self._dat.fileno()).st_size

    @property
    def content_size(self) -> int:
        return self.nm.content_size

    def stat(self) -> VolumeStat:
        m = self.nm.metrics
        return VolumeStat(
            file_count=m.file_count,
            deleted_count=m.deleted_count,
            deleted_bytes=m.deleted_bytes,
            size=self.data_file_size(),
        )

    def garbage_level(self) -> float:
        """Fraction of the .dat occupied by deleted needles
        (volume_vacuum.go garbageLevel)."""
        size = self.data_file_size()
        if size == 0:
            return 0.0
        return self.nm.metrics.deleted_bytes / size

    @property
    def modified_at_second(self) -> int:
        """Epoch second of the last append — the "quiet volume" signal
        the heartbeat carries so the master's maintenance detector can
        apply the full-and-quiet EC-encode predicate
        (command_ec_encode.go:266-297). Falls back to the .dat mtime
        for volumes not written since this process loaded them."""
        if self.last_append_at_ns:
            return self.last_append_at_ns // 1_000_000_000
        try:
            return int(os.path.getmtime(self.data_file_name))
        except OSError:
            return 0

    # -- integrity (volume_checking.go:17-68) ----------------------------

    def check_integrity(self) -> None:
        """Truncate index entries that point past the data file; verify the
        last entry's record is actually on disk."""
        dat_size = self.data_file_size()
        idx_path = self.index_file_name
        idx_size = os.path.getsize(idx_path)
        usable = idx_size - (idx_size % t.NEEDLE_MAP_ENTRY_SIZE)
        with open(idx_path, "rb") as f:
            while usable > 0:
                f.seek(usable - t.NEEDLE_MAP_ENTRY_SIZE)
                key, off, size = t.unpack_idx_entry(
                    f.read(t.NEEDLE_MAP_ENTRY_SIZE)
                )
                if t.size_is_valid(size):
                    end = off + needle_mod.get_actual_size(
                        size, self.version
                    )
                    if end <= dat_size:
                        break
                    usable -= t.NEEDLE_MAP_ENTRY_SIZE
                else:
                    break
        if usable != idx_size:
            self.nm.close()
            with open(idx_path, "r+b") as f:
                f.truncate(usable)
            self.nm = nm_mod.new_needle_map(idx_path, self.needle_map_kind)

    # -- io helpers ------------------------------------------------------

    def _check_open(self) -> None:
        if self.closed:
            raise VolumeClosedError(f"volume {self.id} is closed")

    def _pread(self, offset: int, n: int) -> bytes:
        self._check_open()
        if self.remote_backend is not None:
            return self.remote_backend.read_at(offset, n)
        return os.pread(self._dat.fileno(), n, offset)

    def _append(self, payload: bytes, fsync: bool) -> int:
        """Append at end of .dat; returns the record's byte offset."""
        self._dat.seek(0, os.SEEK_END)
        offset = self._dat.tell()
        if offset % t.NEEDLE_PADDING_SIZE != 0:
            # heal a torn previous append (reference pads on load)
            pad = t.NEEDLE_PADDING_SIZE - (
                offset % t.NEEDLE_PADDING_SIZE
            )
            self._dat.write(bytes(pad))
            offset += pad
        self._dat.write(payload)
        self._dat.flush()
        if fsync:
            os.fsync(self._dat.fileno())
        return offset

    # -- write / read / delete ------------------------------------------

    def write_needle(
        self, n: needle_mod.Needle, fsync: bool = False
    ) -> tuple[int, int]:
        """Append a needle; returns (offset, stored size)."""
        with self._lock:
            self._check_open()
            if self.readonly:
                raise VolumeReadOnlyError(f"volume {self.id} is readonly")
            if offset := self._unchanged_offset(n):
                return offset, self.nm.get(n.id).size
            if n.ttl == t.TTL() and self.ttl.count:
                n.set_ttl(self.ttl)
            n.append_at_ns = time.time_ns()
            payload = n.to_bytes(self.version)
            offset = self._append(payload, fsync)
            if offset >= t.MAX_POSSIBLE_VOLUME_SIZE:
                self._dat.truncate(offset)
                raise VolumeReadOnlyError(
                    f"volume {self.id} exceeded max size"
                )
            self.last_append_at_ns = n.append_at_ns
            self.nm.put(n.id, offset, n.size)
            return offset, n.size

    def _unchanged_offset(self, n: needle_mod.Needle) -> int | None:
        """Dedupe identical overwrites (volume_read_write.go:36-56)."""
        if self.ttl.count:
            return None
        nv = self.nm.get(n.id)
        if nv is None or not t.size_is_valid(nv.size):
            return None
        try:
            old = self.read_needle(n.id, cookie=None)
        except (NotFoundError, DeletedError, needle_mod.ChecksumError):
            return None
        if old.cookie == n.cookie and old.data == n.data:
            return nv.offset
        return None

    def read_needle(
        self, key: int, cookie: int | None = None
    ) -> needle_mod.Needle:
        # the lookup and the pread inside the gate, so both come from
        # the same (needle map, .dat) generation: commit_compact swaps
        # the pair and close() drops it only with the gate alone, and a
        # read that straddled either would parse another file's bytes
        with self._gate.shared():
            self._check_open()
            nv = self.nm.get(key)
            if nv is None or nv.offset == 0:
                raise NotFoundError(f"needle {key:x} not found")
            if t.size_is_deleted(nv.size):
                raise DeletedError(f"needle {key:x} deleted")
            total = needle_mod.get_actual_size(nv.size, self.version)
            record = self._pread(nv.offset, total)
        if len(record) < total:
            raise needle_mod.ChecksumError(
                f"short read for needle {key:x}"
            )
        n = needle_mod.Needle.from_record(record, self.version)
        if cookie is not None and n.cookie != cookie:
            raise NotFoundError(
                f"cookie mismatch for needle {key:x}"
            )
        if n.has(needle_mod.FLAG_HAS_TTL) and n.ttl.seconds:
            if n.has(needle_mod.FLAG_HAS_LAST_MODIFIED):
                if time.time() > n.last_modified + n.ttl.seconds:
                    raise NotFoundError(f"needle {key:x} expired")
        return n

    def delete_needle(self, key: int) -> int:
        """Append a tombstone record; returns freed bytes
        (volume_read_write.go:246-284)."""
        with self._lock:
            self._check_open()
            if self.readonly:
                raise VolumeReadOnlyError(f"volume {self.id} is readonly")
            nv = self.nm.get(key)
            if nv is None or not t.size_is_valid(nv.size):
                return 0
            size = nv.size
            tomb = needle_mod.Needle(id=key, data=b"")
            tomb.append_at_ns = time.time_ns()
            offset = self._append(tomb.to_bytes(self.version), False)
            self.last_append_at_ns = tomb.append_at_ns
            self.nm.delete(key, offset)
            return size

    # -- vacuum (volume_vacuum.go) ---------------------------------------

    def set_replica_placement(
        self, rp: "t.ReplicaPlacement"
    ) -> None:
        """Rewrite the superblock's replica placement in place
        (volume_grpc_admin.go VolumeConfigure; the superblock is the
        first bytes of the .dat)."""
        with self._lock:
            self._check_open()
            if self._dat is None:
                raise VolumeReadOnlyError(
                    f"volume {self.id} is remote-tiered; bring it "
                    f"back (tier.download) before reconfiguring"
                )
            self.super_block.replica_placement = rp
            if self._dat is not None:
                os.pwrite(
                    self._dat.fileno(),
                    self.super_block.to_bytes(),
                    0,
                )
                os.fsync(self._dat.fileno())

    def compact(self, bytes_per_second: int = 0) -> None:
        """Copy live needles to .cpd/.cpx (phase 1, no write lock).

        `bytes_per_second` throttles the copy like the reference's
        `-compactionBytePerSecond` (volume_vacuum.go), keeping
        background compaction from starving foreground disk IO."""
        with self._lock:
            self.is_compacting = True
            self.last_compact_index_offset = os.path.getsize(
                self.index_file_name
            )
            self.last_compact_revision = (
                self.super_block.compaction_revision
            )
        self._copy_data_based_on_index(
            self.base_file_name + ".cpd",
            self.base_file_name + ".cpx",
            bytes_per_second,
        )

    def _copy_data_based_on_index(
        self, dst_dat: str, dst_idx: str, bytes_per_second: int = 0
    ) -> None:
        sb = sb_mod.SuperBlock(
            version=self.version,
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=self.super_block.compaction_revision + 1,
        )
        from ..util.limiter import BytesThrottler

        throttler = BytesThrottler(bytes_per_second)
        new_map: list[tuple[int, int, int]] = []
        with open(dst_dat, "wb") as out:
            out.write(sb.to_bytes())
            pos = sb.block_size
            for key, nv in self.nm.ascending_visit():
                if not t.size_is_valid(nv.size):
                    continue
                total = needle_mod.get_actual_size(nv.size, self.version)
                record = self._pread(nv.offset, total)
                out.write(record)
                throttler.throttle(total)
                new_map.append((key, pos, nv.size))
                pos += total
        with open(dst_idx, "wb") as out:
            for key, off, size in new_map:
                out.write(t.pack_idx_entry(key, off, size))

    def commit_compact(self) -> None:
        """Apply writes that raced with compaction (makeupDiff,
        volume_vacuum.go:179+), then atomically swap files."""
        with self._lock:
            try:
                self._check_open()
                self._makeup_diff()
                with self._gate.alone():
                    self.nm.close()
                    self._dat.close()
                    os.replace(
                        self.base_file_name + ".cpd", self.data_file_name
                    )
                    os.replace(
                        self.base_file_name + ".cpx", self.index_file_name
                    )
                    self._dat = open(self.data_file_name, "r+b")
                    with open(self.data_file_name, "rb") as f:
                        self.super_block = sb_mod.SuperBlock.from_bytes(
                            f.read(sb_mod.SUPER_BLOCK_SIZE + 0xFFFF)
                        )
                    self.nm = nm_mod.new_needle_map(
                        self.index_file_name, self.needle_map_kind
                    )
            finally:
                self.is_compacting = False

    def _makeup_diff(self) -> None:
        """Replay idx entries appended since compact() into the .cpd/.cpx."""
        idx_size = os.path.getsize(self.index_file_name)
        if idx_size <= self.last_compact_index_offset:
            return
        with open(self.index_file_name, "rb") as f:
            f.seek(self.last_compact_index_offset)
            delta = f.read(idx_size - self.last_compact_index_offset)
        cpd = open(self.base_file_name + ".cpd", "r+b")
        cpx = open(self.base_file_name + ".cpx", "ab")
        try:
            # build key → cpx position map for overwrites/deletes
            cpx.flush()
            with open(self.base_file_name + ".cpx", "rb") as f:
                existing = {}
                pos = 0
                while True:
                    e = f.read(t.NEEDLE_MAP_ENTRY_SIZE)
                    if len(e) < t.NEEDLE_MAP_ENTRY_SIZE:
                        break
                    key, _, _ = t.unpack_idx_entry(e)
                    existing[key] = pos
                    pos += t.NEEDLE_MAP_ENTRY_SIZE
            for i in range(0, len(delta), t.NEEDLE_MAP_ENTRY_SIZE):
                key, off, size = t.unpack_idx_entry(
                    delta[i : i + t.NEEDLE_MAP_ENTRY_SIZE]
                )
                if t.size_is_valid(size):
                    total = needle_mod.get_actual_size(size, self.version)
                    record = self._pread(off, total)
                    cpd.seek(0, os.SEEK_END)
                    new_off = cpd.tell()
                    cpd.write(record)
                    entry = t.pack_idx_entry(key, new_off, size)
                else:
                    entry = t.pack_idx_entry(
                        key, 0, t.TOMBSTONE_FILE_SIZE
                    )
                if key in existing and t.size_is_valid(size):
                    with open(self.base_file_name + ".cpx", "r+b") as f:
                        f.seek(existing[key])
                        f.write(entry)
                else:
                    cpx.write(entry)
        finally:
            cpd.close()
            cpx.close()

    # -- incremental backup (volume_backup.go:170) -----------------------

    def binary_search_by_append_at_ns(self, since_ns: int) -> int:
        """Earliest .dat offset whose record has append_at_ns >= since_ns;
        scans the idx-ordered offsets with bisection over record reads."""
        offsets = sorted(
            nv.offset for _, nv in self.nm.ascending_visit()
        )
        lo, hi = 0, len(offsets)
        while lo < hi:
            mid = (lo + hi) // 2
            n = self._read_record_at(offsets[mid])
            if n.append_at_ns < since_ns:
                lo = mid + 1
            else:
                hi = mid
        return (
            offsets[lo] if lo < len(offsets) else self.data_file_size()
        )

    def _read_record_at(self, offset: int) -> needle_mod.Needle:
        head = self._pread(offset, t.NEEDLE_HEADER_SIZE)
        n = needle_mod.Needle.parse_header(head)
        total = needle_mod.get_actual_size(n.size, self.version)
        return needle_mod.Needle.from_record(
            self._pread(offset, total), self.version
        )

    # -- lifecycle -------------------------------------------------------

    def sync(self) -> None:
        if self._dat is not None:
            self._dat.flush()
            os.fsync(self._dat.fileno())
        self.nm.sync()

    def close(self) -> None:
        """Close the files; a later read, write or stat raises
        ``VolumeClosedError``. Idempotent."""
        with self._lock, self._gate.alone():
            if self.closed:
                return
            self.closed = True
            self.nm.close()
            if self._dat is not None:
                self._dat.close()
                self._dat = None
            if self.remote_backend is not None:
                self.remote_backend.close()

    def destroy(self) -> None:
        self.close()
        for ext in (".dat", ".idx", ".cpd", ".cpx", ".vif", ".note"):
            p = self.base_file_name + ext
            if os.path.exists(p):
                os.remove(p)

    def file_id(self, n: needle_mod.Needle) -> FileId:
        return FileId(self.id, n.id, n.cookie)
