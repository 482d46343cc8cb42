""".idx needle-index file: a flat log of 16- or 17-byte entries.

Entry = needle id u64 | offset u32 (units of 8 bytes) [+1 high byte in
the 5-byte "large disk" width] | size i32, all big-endian. The active
width comes from ``types.OFFSET_SIZE``.

The port's copy of ``seaweedfs_tpu/storage/idx.py``: the whole file
parses as strided numpy columns.
"""

from __future__ import annotations

import numpy as np

from . import types as t

ENTRY_DTYPE = [("key", "u8"), ("offset", "i8"), ("size", "i4")]


def parse_entries(buf: bytes) -> np.ndarray:
    """Bytes → structured array with key/offset(bytes)/size columns."""
    entry = t.NEEDLE_MAP_ENTRY_SIZE
    osz = t.OFFSET_SIZE
    usable = len(buf) - (len(buf) % entry)
    raw = np.frombuffer(buf[:usable], dtype=np.uint8).reshape(-1, entry)
    keys = raw[:, :8].copy().view(">u8").reshape(-1)
    offsets = raw[:, 8:12].copy().view(">u4").reshape(-1).astype(np.int64)
    if osz == 5:
        # 5th byte carries bits 32-39
        offsets |= raw[:, 12].astype(np.int64) << 32
    sizes = raw[:, 8 + osz : 12 + osz].copy().view(">i4").reshape(-1)
    out = np.zeros(len(keys), dtype=ENTRY_DTYPE)
    out["key"] = keys
    out["offset"] = offsets * t.NEEDLE_PADDING_SIZE
    out["size"] = sizes
    return out


def pack_entries(entries: np.ndarray) -> bytes:
    """Structured array (as from parse_entries) → .idx bytes."""
    entry = t.NEEDLE_MAP_ENTRY_SIZE
    osz = t.OFFSET_SIZE
    n = len(entries)
    raw = np.zeros((n, entry), dtype=np.uint8)
    raw[:, :8] = entries["key"].astype(">u8").view(np.uint8).reshape(n, 8)
    stored = (entries["offset"] // t.NEEDLE_PADDING_SIZE).astype(np.int64)
    if n and int(stored.max()) >> (8 * osz):
        raise ValueError(
            f"offset exceeds the {osz}-byte volume limit "
            f"({t.MAX_POSSIBLE_VOLUME_SIZE} bytes)"
        )
    raw[:, 8:12] = (
        (stored & 0xFFFFFFFF).astype(">u4").view(np.uint8).reshape(n, 4)
    )
    if osz == 5:
        raw[:, 12] = (stored >> 32).astype(np.uint8)
    raw[:, 8 + osz : 12 + osz] = (
        entries["size"].astype(">i4").view(np.uint8).reshape(n, 4)
    )
    return raw.tobytes()


def sort_by_key(entries: np.ndarray) -> np.ndarray:
    """Stable sort by needle id — the ``.ecx`` ordering."""
    return entries[np.argsort(entries["key"], kind="stable")]


def fold_entries(entries: np.ndarray) -> np.ndarray:
    """Fold a raw append-only ``.idx`` log to latest-state per needle id,
    ascending by key: in file order, a tombstone (offset 0 or deleted
    size) removes the key, a valid entry replaces it.

    Vectorized: the LAST occurrence of each key wins, then keys whose
    last state is a delete are dropped.
    """
    if len(entries) == 0:
        return entries
    order = np.argsort(entries["key"], kind="stable")
    sorted_keys = entries["key"][order]
    group_last = np.append(sorted_keys[1:] != sorted_keys[:-1], True)
    latest = entries[order[group_last]]
    deleted = (latest["offset"] == 0) | (latest["size"] < 0)
    return latest[~deleted]
