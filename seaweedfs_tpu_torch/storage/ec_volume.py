"""EC volume: serve needle reads from `.ecNN` shard files + `.ecx` index.

The port's counterpart of ``seaweedfs_tpu/storage/ec_volume.py``
(SeaweedFS weed/storage/erasure_coding/ec_volume.go:24-250, ec_shard.go,
store_ec.go:124-378). A volume server holds some subset of the 14
shards locally; reads locate needle intervals, serve local bytes
directly, fetch remote shards through a caller-provided reader, and fall
back to on-the-fly GF reconstruction from any k reachable shards — the
read-time self-healing path, on the port's codec: a window under the
codec's floor on the native host codec, a wider one on the card.

One difference from the reference, in how and not in what: a
reconstruction reads its k survivor windows into the rows of one
``rs.host_zeros((k, n))`` buffer (pinned on ``cuda``), which the codec
then takes as it is, with no stacking copy.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable

import numpy as np
import torch

from ..ops.codec import RSCodec
from . import backend as backend_mod
from . import idx as idx_mod, needle as needle_mod, types as t
from .erasure_coding import constants as C
from .erasure_coding.layout import (
    Interval,
    locate_data,
    to_shard_id_and_offset,
)
from .super_block import SUPER_BLOCK_SIZE, SuperBlock


class EcShard:
    """One local `.ecNN` file. A read and a close take the shard's lock,
    so a read never lands on a closed descriptor (or on another file
    that reused its number); a shard closed under a reader reads as
    absent, and the reader falls back to a remote copy or a
    reconstruction."""

    def __init__(self, base_file_name: str, shard_id: int):
        self.base = base_file_name
        self.shard_id = shard_id
        self.path = base_file_name + C.to_ext(shard_id)
        self._lock = threading.Lock()
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, n: int) -> bytes:
        with self._lock:
            if self._f is None:
                return b""
            return os.pread(self._f.fileno(), n, offset)

    def read_into(self, offset: int, out: np.ndarray) -> int:
        """Read ``out.nbytes`` bytes at ``offset`` into ``out``; returns
        the bytes read (fewer past the end of the file, 0 once the shard
        is closed)."""
        with self._lock:
            if self._f is None:
                return 0
            return os.preadv(self._f.fileno(), [memoryview(out)], offset)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def destroy(self) -> None:
        self.close()
        os.remove(self.path)


class EcVolume:
    """Locally-present shards of one EC volume + the .ecx needle index.

    ``rs`` is the codec of reconstructions (default: RS(10,4) on
    ``device``; ``device=None`` means the card and raises without one)."""

    def __init__(
        self,
        base_file_name: str,
        vid: int,
        collection: str = "",
        rs: RSCodec | None = None,
        shard_ids: list[int] | None = None,
        device: str | torch.device | None = None,
    ):
        self.base = base_file_name
        self.id = vid
        self.collection = collection
        self.rs = rs or RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device)
        self.shards: dict[int, EcShard] = {}
        self._lock = threading.Lock()
        # .ecx entries are offset-width dependent: refuse a width
        # mismatch before misparsing
        backend_mod.check_volume_offset_width(
            base_file_name, f"ec volume {vid}"
        )
        with open(base_file_name + ".ecx", "rb") as f:
            self._ecx = idx_mod.parse_entries(f.read())
        self._ecx_keys = np.ascontiguousarray(self._ecx["key"])
        # apply the deletion journal view (sizes already folded on decode)
        self._deleted: set[int] = set()
        ecj = base_file_name + ".ecj"
        if os.path.exists(ecj):
            with open(ecj, "rb") as f:
                buf = f.read()
            for i in range(0, len(buf) - 7, 8):
                self._deleted.add(
                    struct.unpack(">Q", buf[i : i + 8])[0]
                )
        wanted = (
            range(C.TOTAL_SHARDS) if shard_ids is None else shard_ids
        )
        for sid in wanted:
            if os.path.exists(base_file_name + C.to_ext(sid)):
                self.add_shard(sid)
        # Version resolution: shard 0's embedded superblock is
        # authoritative when present; otherwise the .vif — which travels
        # with every shard copy (pb/volume_info.go) — covers nodes holding
        # only shards 1-13 of a v1/v2 volume.
        self.version = t.CURRENT_VERSION
        head = (
            self.shards[0].read_at(0, SUPER_BLOCK_SIZE)
            if 0 in self.shards
            else b""
        )
        if len(head) == SUPER_BLOCK_SIZE:
            self.version = SuperBlock.from_bytes(head).version
        else:
            vif = backend_mod.load_volume_info(base_file_name)
            if vif.get("version"):
                self.version = int(vif["version"])

    # -- shard management ------------------------------------------------

    def add_shard(self, shard_id: int) -> bool:
        with self._lock:
            if shard_id in self.shards:
                return False
            self.shards[shard_id] = EcShard(self.base, shard_id)
            return True

    def delete_shard(self, shard_id: int) -> None:
        with self._lock:
            shard = self.shards.pop(shard_id, None)
            if shard:
                shard.close()

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    @property
    def shard_size(self) -> int:
        return next(
            (s.size for s in list(self.shards.values())), 0
        )

    # -- needle lookup (ec_volume.go:205-250) ----------------------------

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """Binary search the sorted .ecx → (dat offset, size)."""
        i = int(np.searchsorted(self._ecx_keys, needle_id))
        if i >= len(self._ecx_keys) or int(self._ecx_keys[i]) != needle_id:
            raise KeyError(f"needle {needle_id:x} not in ecx")
        e = self._ecx[i]
        return int(e["offset"]), int(e["size"])

    def locate_needle(
        self, needle_id: int
    ) -> tuple[int, int, list[Interval]]:
        offset, size = self.find_needle_from_ecx(needle_id)
        if needle_id in self._deleted or t.size_is_deleted(size):
            raise KeyError(f"needle {needle_id:x} deleted")
        dat_size = C.DATA_SHARDS * self.shard_size
        total = needle_mod.get_actual_size(size, self.version)
        intervals = locate_data(offset, total, dat_size)
        return offset, size, intervals

    # -- deletion (ec_volume_delete.go:27-51) ----------------------------

    def delete_needle(self, needle_id: int) -> None:
        """Mark deleted: append the id to the .ecj journal."""
        with self._lock:
            with open(self.base + ".ecj", "ab") as f:
                f.write(struct.pack(">Q", needle_id))
            self._deleted.add(needle_id)

    # -- reads (store_ec.go:124-378) -------------------------------------

    def read_needle(
        self,
        needle_id: int,
        remote_read: Callable[[int, int, int], bytes | None] | None = None,
    ) -> needle_mod.Needle:
        """Read + parse a needle, reconstructing intervals if needed.

        `remote_read(shard_id, offset, n)` fetches bytes of a shard this
        node doesn't hold (server wires it to peer RPC); returning None
        means that shard is unreachable and reconstruction kicks in.
        """
        _, size, intervals = self.locate_needle(needle_id)
        data = b"".join(
            self._read_interval(iv, remote_read) for iv in intervals
        )
        n = needle_mod.Needle.parse_header(data)
        body_len = needle_mod.needle_body_length(n.size, self.version)
        n.parse_body(
            data[t.NEEDLE_HEADER_SIZE : t.NEEDLE_HEADER_SIZE + body_len],
            self.version,
        )
        return n

    def _read_interval(
        self,
        iv: Interval,
        remote_read: Callable[[int, int, int], bytes | None] | None,
    ) -> bytes:
        sid, off = to_shard_id_and_offset(iv)
        # one lookup: a shard unmounted under this read is absent (its
        # close makes read_at answer nothing), never a KeyError
        shard = self.shards.get(sid)
        if shard is not None:
            buf = shard.read_at(off, iv.size)
            if len(buf) == iv.size:
                return buf
        if remote_read is not None:
            buf = remote_read(sid, off, iv.size)
            if buf is not None and len(buf) == iv.size:
                return buf
        return self._reconstruct_interval(sid, off, iv.size, remote_read)

    def _reconstruct_interval(
        self,
        missing_sid: int,
        off: int,
        n: int,
        remote_read: Callable[[int, int, int], bytes | None] | None,
    ) -> bytes:
        """On-the-fly recovery: gather this byte window from >= k other
        shards, in ascending id order, into the rows of one codec buffer,
        and reconstruct the missing one (store_ec.go:324-378)."""
        k = self.rs.data_shards
        stack = self.rs.host_zeros((k, n))
        got: list[int] = []
        for sid in range(C.TOTAL_SHARDS):
            if sid == missing_sid:
                continue
            row = stack[len(got)]
            shard = self.shards.get(sid)
            if shard is not None:
                ok = shard.read_into(off, row) == n
            elif remote_read is not None:
                buf = remote_read(sid, off, n)
                ok = buf is not None and len(buf) == n
                if ok:
                    row[:] = np.frombuffer(buf, dtype=np.uint8)
            else:
                ok = False
            if ok:
                got.append(sid)
            if len(got) >= k:
                break
        if len(got) < k:
            raise IOError(
                f"ec volume {self.id}: only {len(got)} shards "
                f"reachable, need {k}"
            )
        gathered = {sid: stack[i] for i, sid in enumerate(got)}
        rebuilt = self.rs.reconstruct(gathered, wanted=[missing_sid])
        return rebuilt[missing_sid].tobytes()

    def close(self) -> None:
        # unmount races shard reads/mounts on handler threads: the
        # shard-map teardown shares the volume lock with them
        with self._lock:
            for s in self.shards.values():
                s.close()
            self.shards.clear()

    def destroy(self) -> None:
        with self._lock:
            for s in list(self.shards.values()):
                s.destroy()
            self.shards.clear()
        for ext in (".ecx", ".ecj", ".vif"):
            p = self.base + ext
            if os.path.exists(p):
                os.remove(p)


class ShardBits:
    """uint32 bitmask of shard ids (ec_volume_info.go:65-117)."""

    def __init__(self, bits: int = 0):
        self.bits = bits & 0xFFFFFFFF

    def add(self, sid: int) -> "ShardBits":
        return ShardBits(self.bits | (1 << sid))

    def remove(self, sid: int) -> "ShardBits":
        return ShardBits(self.bits & ~(1 << sid))

    def has(self, sid: int) -> bool:
        return bool(self.bits & (1 << sid))

    def ids(self) -> list[int]:
        return [i for i in range(C.TOTAL_SHARDS) if self.has(i)]

    def count(self) -> int:
        return bin(self.bits).count("1")

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits | other.bits)

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits & ~other.bits)

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardBits) and self.bits == other.bits

    def __repr__(self) -> str:
        return f"ShardBits({self.ids()})"
