"""Scalar storage types of the port's on-disk formats.

The port's copy of ``seaweedfs_tpu/storage/types.py``. Byte-compatible with SeaweedFS's formats (all integers
big-endian):

* NeedleId — u64
* Offset   — stored in units of the 8-byte needle padding; 4 bytes by
  default (32 GiB volumes), 5 in the "large disk" build
* Size     — i32; negative (-1) is the deletion tombstone
* Cookie   — u32 random per needle, guards against guessed fids
* TTL      — 2 bytes (count, unit)
* ReplicaPlacement — one byte, decimal digits DC/rack/server

The offset width follows ``WEED_LARGE_DISK`` as in the reference, read
once at import; the reference's runtime ``set_offset_size`` is not
ported (no caller of the port switches widths).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
TOMBSTONE_FILE_SIZE = -1

OFFSET_SIZE = (
    5 if os.environ.get("WEED_LARGE_DISK", "").lower()
    in ("1", "true", "yes", "on") else 4
)
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING_SIZE

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


# -- TTL ---------------------------------------------------------------------

TTL_EMPTY_UNIT = 0
_TTL_UNITS = {  # readable suffix → (stored unit byte, seconds per unit)
    "m": (1, 60),
    "h": (2, 3600),
    "d": (3, 86400),
    "w": (4, 7 * 86400),
    "M": (5, 30 * 86400),
    "y": (6, 365 * 86400),
}
_UNIT_TO_SUFFIX = {u: s for s, (u, _) in _TTL_UNITS.items()}
_UNIT_SECONDS = {u: sec for _, (u, sec) in _TTL_UNITS.items()}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = TTL_EMPTY_UNIT

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """"3m", "4h", "5d", "6w", "7M", "8y"; bare digits mean minutes."""
        if not s:
            return cls()
        if s[-1].isdigit():
            return cls(count=int(s), unit=_TTL_UNITS["m"][0])
        suffix = s[-1]
        if suffix not in _TTL_UNITS:
            raise ValueError(f"unknown ttl unit {suffix!r}")
        return cls(count=int(s[:-1]), unit=_TTL_UNITS[suffix][0])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        return cls(count=b[0], unit=b[1])

    @classmethod
    def from_uint32(cls, v: int) -> "TTL":
        return cls(count=(v >> 8) & 0xFF, unit=v & 0xFF)

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    @property
    def seconds(self) -> int:
        if self.count == 0 or self.unit == TTL_EMPTY_UNIT:
            return 0
        return self.count * _UNIT_SECONDS[self.unit]

    def __str__(self) -> str:
        if self.count == 0 or self.unit == TTL_EMPTY_UNIT:
            return ""
        return f"{self.count}{_UNIT_TO_SUFFIX[self.unit]}"


# -- Replica placement -------------------------------------------------------


@dataclass(frozen=True)
class ReplicaPlacement:
    diff_data_center_count: int = 0
    diff_rack_count: int = 0
    same_rack_count: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"replication {s!r} must be 3 digits like '001'")
        x, y, z = (int(c) for c in s)
        if max(x, y, z) > 2:
            raise ValueError(f"replication digit > 2 in {s!r}")
        return cls(x, y, z)

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return (
            self.diff_data_center_count * 100
            + self.diff_rack_count * 10
            + self.same_rack_count
        )

    @property
    def copy_count(self) -> int:
        return (
            self.diff_data_center_count
            + self.diff_rack_count
            + self.same_rack_count
            + 1
        )

    def __str__(self) -> str:
        return (
            f"{self.diff_data_center_count}"
            f"{self.diff_rack_count}{self.same_rack_count}"
        )


def offset_to_actual(stored: int) -> int:
    """Stored offset (units of the padding) → byte offset in the .dat."""
    return stored * NEEDLE_PADDING_SIZE


def actual_to_offset(actual: int) -> int:
    assert actual % NEEDLE_PADDING_SIZE == 0, actual
    return actual // NEEDLE_PADDING_SIZE


_IDX_ENTRY = struct.Struct(">QIi")  # needle id, offset(÷8), size
# 5-byte layout: 4 bytes big-endian low-32, then ONE extra byte carrying
# bits 32-39
_IDX_ENTRY5_HEAD = struct.Struct(">QI")
_IDX_ENTRY5_TAIL = struct.Struct(">Bi")


def pack_idx_entry(key: int, offset_bytes: int, size: int) -> bytes:
    stored = actual_to_offset(offset_bytes)
    if stored >> (8 * OFFSET_SIZE):
        raise ValueError(
            f"offset {offset_bytes} exceeds the {OFFSET_SIZE}-byte "
            f"volume limit ({MAX_POSSIBLE_VOLUME_SIZE} bytes)"
        )
    if OFFSET_SIZE == 4:
        return _IDX_ENTRY.pack(key, stored, size)
    return _IDX_ENTRY5_HEAD.pack(
        key, stored & 0xFFFFFFFF
    ) + _IDX_ENTRY5_TAIL.pack(stored >> 32, size)


def unpack_idx_entry(b: bytes) -> tuple[int, int, int]:
    """One idx entry (16 or 17 bytes) → (needle id, byte offset, size)."""
    if OFFSET_SIZE == 4:
        key, off, size = _IDX_ENTRY.unpack(b)
        return key, offset_to_actual(off), size
    key, low = _IDX_ENTRY5_HEAD.unpack(b[:12])
    high, size = _IDX_ENTRY5_TAIL.unpack(b[12:17])
    return key, offset_to_actual(low | (high << 32)), size
