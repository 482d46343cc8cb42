"""Chunk overlap algebra: resolve a chunk list into visible intervals.

Behavioral model: weed/filer/filechunks.go:16-100+ — chunks are applied in
mtime order; later writes shadow earlier bytes; readers see only the
visible fragments of each chunk.

The port's copy of ``seaweedfs_tpu/filer/filechunks.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .entry import FileChunk


@dataclass
class VisibleInterval:
    start: int
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int  # this interval starts at chunk_offset in its chunk
    chunk_size: int


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def non_overlapping_visible_intervals(
    chunks: list[FileChunk],
) -> list[VisibleInterval]:
    """Apply chunks in mtime order; newer chunks cut holes into older
    visible spans (filechunks.go MergeIntoVisibles)."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.mtime, c.offset)):
        new_v = VisibleInterval(
            start=chunk.offset,
            stop=chunk.offset + chunk.size,
            file_id=chunk.file_id,
            mtime=chunk.mtime,
            chunk_offset=0,
            chunk_size=chunk.size,
        )
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.stop <= new_v.start or v.start >= new_v.stop:
                out.append(v)  # no overlap
                continue
            if v.start < new_v.start:  # left remainder survives
                out.append(
                    VisibleInterval(
                        start=v.start,
                        stop=new_v.start,
                        file_id=v.file_id,
                        mtime=v.mtime,
                        chunk_offset=v.chunk_offset,
                        chunk_size=v.chunk_size,
                    )
                )
            if v.stop > new_v.stop:  # right remainder survives
                out.append(
                    VisibleInterval(
                        start=new_v.stop,
                        stop=v.stop,
                        file_id=v.file_id,
                        mtime=v.mtime,
                        chunk_offset=v.chunk_offset
                        + (new_v.stop - v.start),
                        chunk_size=v.chunk_size,
                    )
                )
        out.append(new_v)
        out.sort(key=lambda v: v.start)
        visibles = out
    return visibles


def read_resolved_chunks(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[tuple[VisibleInterval, int, int]]:
    """Which (interval, read-offset-in-chunk, length) cover
    [offset, offset+size)? Gaps (sparse holes) are skipped — callers
    zero-fill."""
    out = []
    stop = offset + size
    for v in visibles:
        if v.stop <= offset or v.start >= stop:
            continue
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        out.append((v, v.chunk_offset + (lo - v.start), hi - lo))
    return out
