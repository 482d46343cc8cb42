"""Striping layout math: volume byte ranges ↔ (shard id, shard file offset).

A volume's .dat is striped row-major over k data shards: first `nLarge`
rows of k×LARGE blocks (while more than k×LARGE bytes remain), then rows
of k×SMALL blocks, the final row zero-padded. Shard file i holds its
column: all its large blocks, then all its small blocks.

The port's copy of ``seaweedfs_tpu/storage/erasure_coding/layout.py``
(SeaweedFS weed/storage/erasure_coding/ec_locate.go:15-87). SeaweedFS's
two row-count formulas (`datSize/(k·large)` in locateOffset vs
`(datSize + k·small)/(k·large)` in LocateData) disagree in a ~k·small
window below exact multiples of k·large; both are reproduced verbatim
for byte compatibility.
"""

from __future__ import annotations

from dataclasses import dataclass

from .constants import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int


def locate_offset(
    offset: int,
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
    k: int = DATA_SHARDS,
) -> tuple[int, bool, int]:
    """Volume offset → (block index, is large, offset within block)."""
    large_row = large * k
    n_large_rows = dat_size // large_row
    if offset < n_large_rows * large_row:
        return offset // large, True, offset % large
    offset -= n_large_rows * large_row
    return offset // small, False, offset % small


def locate_data(
    offset: int,
    size: int,
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
    k: int = DATA_SHARDS,
) -> list[Interval]:
    """Volume byte range → list of block-aligned intervals."""
    block_index, is_large, inner = locate_offset(
        offset, dat_size, large, small, k
    )
    # "+ k*small ensures we can derive the number of large block rows
    # from a shard size" (ec_locate.go:18-19)
    n_large_rows = (dat_size + k * small) // (large * k)
    intervals: list[Interval] = []
    while size > 0:
        block_len = large if is_large else small
        take = min(size, block_len - inner)
        intervals.append(
            Interval(block_index, inner, take, is_large, n_large_rows)
        )
        size -= take
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == n_large_rows * k:
            is_large = False
            block_index = 0
        inner = 0
    return intervals


def to_shard_id_and_offset(
    interval: Interval,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
    k: int = DATA_SHARDS,
) -> tuple[int, int]:
    """Interval → (shard id, byte offset inside that shard's file)."""
    off = interval.inner_block_offset
    row = interval.block_index // k
    if interval.is_large_block:
        off += row * large
    else:
        off += interval.large_block_rows_count * large + row * small
    return interval.block_index % k, off


# -- encoder-side row geometry ----------------------------------------------


def encode_row_plan(
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
    k: int = DATA_SHARDS,
) -> list[tuple[int, int]]:
    """Rows the encoder writes: list of (dat start offset, block size).

    Large rows while *strictly more than* k·large bytes remain, then
    zero-padded small rows while any bytes remain (ec_encoder.go:194-231).
    """
    rows: list[tuple[int, int]] = []
    processed, remaining = 0, dat_size
    while remaining > large * k:
        rows.append((processed, large))
        processed += large * k
        remaining -= large * k
    while remaining > 0:
        rows.append((processed, small))
        processed += small * k
        remaining -= small * k
    return rows


def shard_file_size(
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
    k: int = DATA_SHARDS,
) -> int:
    """Size of each generated shard file for a dat of `dat_size` bytes."""
    return sum(bs for _, bs in encode_row_plan(dat_size, large, small, k))
