"""Volume superblock: the first 8 bytes of every .dat file.

The port's copy of ``seaweedfs_tpu/storage/super_block.py``. Layout
(SeaweedFS weed/storage/super_block/super_block.go:16-23):
  byte 0: needle version (1..3)
  byte 1: replica placement byte ("xyz" digits)
  bytes 2-3: TTL (count, unit)
  bytes 4-5: compaction revision u16 BE
  bytes 6-7: extra-size u16 BE (pb-encoded extra follows if nonzero)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import types as t

SUPER_BLOCK_SIZE = 8


@dataclass
class SuperBlock:
    version: int = t.CURRENT_VERSION
    replica_placement: t.ReplicaPlacement = field(
        default_factory=t.ReplicaPlacement
    )
    ttl: t.TTL = field(default_factory=t.TTL)
    compaction_revision: int = 0
    extra: bytes = b""

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", header, 4, self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            struct.pack_into(">H", header, 6, len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block too short")
        version = b[0]
        if version not in (t.VERSION1, t.VERSION2, t.VERSION3):
            raise ValueError(f"unsupported volume version {version}")
        sb = cls(
            version=version,
            replica_placement=t.ReplicaPlacement.from_byte(b[1]),
            ttl=t.TTL.from_bytes(b[2:4]),
            compaction_revision=struct.unpack(">H", b[4:6])[0],
        )
        extra_size = struct.unpack(">H", b[6:8])[0]
        if extra_size:
            sb.extra = b[SUPER_BLOCK_SIZE : SUPER_BLOCK_SIZE + extra_size]
        return sb

    @property
    def block_size(self) -> int:
        return SUPER_BLOCK_SIZE + len(self.extra)
