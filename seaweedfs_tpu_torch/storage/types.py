"""Scalar storage types the port's ``.idx`` handling needs.

The port's copy of the part of ``seaweedfs_tpu/storage/types.py`` that
``storage/idx.py`` uses. Byte-compatible with SeaweedFS's formats (all
integers big-endian):

* NeedleId — u64
* Offset   — stored in units of the 8-byte needle padding; 4 bytes by
  default (32 GiB volumes), 5 in the "large disk" build
* Size     — i32; negative (-1) is the deletion tombstone

The offset width follows ``WEED_LARGE_DISK`` as in the reference, read
once at import; the reference's runtime ``set_offset_size`` comes with
the port of the volume engine.
"""

from __future__ import annotations

import os

NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
NEEDLE_PADDING_SIZE = 8
TOMBSTONE_FILE_SIZE = -1

OFFSET_SIZE = (
    5 if os.environ.get("WEED_LARGE_DISK", "").lower()
    in ("1", "true", "yes", "on") else 4
)
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING_SIZE


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE
