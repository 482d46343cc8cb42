"""Dirty-page interval buffering for the FUSE write path.

Behavioral model: weed/filesys/dirty_page_interval.go (ContinuousIntervals:
sorted, non-overlapping written spans, merged on overlap/adjacency) +
weed/filesys/dirty_page.go (ContinuousDirtyPages: when a span reaches
chunk size it is saved to storage as a FileChunk and trimmed from memory,
so an arbitrarily large sequential write holds O(chunk_size) RAM).

The saved chunks are appended to the entry's chunk list on flush; the
filer's overlap algebra (mtime ordering in
filer/filechunks.py non_overlapping_visible_intervals) resolves rewrites,
exactly like the reference's saveToStorage + entry.Chunks append path.

The port's copy of ``seaweedfs_tpu/mount/page_writer.py``.
"""

from __future__ import annotations

import time
from typing import Callable

# upload_fn(data) -> file_id on a volume server
UploadFn = Callable[[bytes], str]


class IntervalPages:
    """Sorted, non-overlapping dirty spans; writes merge on contact."""

    def __init__(self):
        # list of [start, bytearray], sorted by start, gap between all
        self.intervals: list[list] = []

    def write(self, offset: int, data: bytes) -> None:
        end = offset + len(data)
        # fast path for sequential writes (the dominant FUSE pattern):
        # append in place to a span ending exactly at `offset`, avoiding
        # the O(span) re-copy per write
        for i, (start, buf) in enumerate(self.intervals):
            if start + len(buf) == offset and not any(
                s < end and s + len(b) > offset
                for j, (s, b) in enumerate(self.intervals)
                if j != i
            ):
                buf += data
                return
        merged_start = offset
        merged_parts: list[tuple[int, bytes | bytearray]] = [(offset, data)]
        keep: list[list] = []
        for start, buf in self.intervals:
            if start + len(buf) < offset or start > end:
                keep.append([start, buf])  # disjoint, not even touching
                continue
            # overlaps or touches: fold into the merged span
            merged_start = min(merged_start, start)
            merged_parts.append((start, buf))
        lo = merged_start
        hi = max(s + len(b) for s, b in merged_parts)
        out = bytearray(hi - lo)
        # older intervals first, the new write last so it wins overlaps
        for s, b in merged_parts[1:] + merged_parts[:1]:
            out[s - lo : s - lo + len(b)] = b
        keep.append([lo, out])
        keep.sort(key=lambda iv: iv[0])
        self.intervals = keep

    def total_bytes(self) -> int:
        return sum(len(b) for _, b in self.intervals)

    def pop_largest(self) -> tuple[int, bytearray] | None:
        if not self.intervals:
            return None
        idx = max(
            range(len(self.intervals)),
            key=lambda i: len(self.intervals[i][1]),
        )
        start, buf = self.intervals.pop(idx)
        return start, buf

    def covers(self, offset: int, size: int) -> bool:
        """Is [offset, offset+size) entirely inside one dirty span?"""
        for start, buf in self.intervals:
            if start <= offset and offset + size <= start + len(buf):
                return True
        return False

    def read(self, offset: int, size: int) -> bytes:
        """Read from dirty spans only (caller checked covers())."""
        for start, buf in self.intervals:
            if start <= offset and offset + size <= start + len(buf):
                return bytes(buf[offset - start : offset - start + size])
        raise ValueError("range not covered by dirty pages")

    def extent(self) -> int:
        return max(
            (s + len(b) for s, b in self.intervals), default=0
        )


class PageWriter:
    """Per-open-file dirty page writer with bounded memory.

    Accumulates writes in IntervalPages; once any span reaches
    chunk_size (or total buffered crosses 2x), the largest span is
    uploaded as FileChunk-sized pieces and dropped from memory
    (dirty_page.go saveExistingLargestPageToStorage model).
    """

    def __init__(self, upload_fn: UploadFn, chunk_size: int):
        self.upload = upload_fn
        self.chunk_size = chunk_size
        self.pages = IntervalPages()
        self.chunks: list[dict] = []  # FileChunk dicts saved so far
        self.extent = 0

    def write(self, offset: int, data: bytes) -> None:
        self.pages.write(offset, data)
        self.extent = max(self.extent, offset + len(data))
        while self.pages.total_bytes() >= 2 * self.chunk_size:
            before = self.pages.total_bytes()
            self._save_largest(full_only=True)
            if self.pages.total_bytes() == before:
                # every span is sub-chunk-sized (scattered writes):
                # force-save the largest anyway so memory stays bounded
                self._save_largest(full_only=False)

    def _save_largest(self, full_only: bool) -> None:
        popped = self.pages.pop_largest()
        if popped is None:
            return
        start, buf = popped
        pos = 0
        while len(buf) - pos >= self.chunk_size:
            self._save_piece(start + pos, buf[pos : pos + self.chunk_size])
            pos += self.chunk_size
        rest = buf[pos:]
        if rest:
            if full_only:
                # remainder smaller than a chunk stays dirty
                self.pages.write(start + pos, bytes(rest))
            else:
                self._save_piece(start + pos, rest)

    def _save_piece(self, offset: int, data) -> None:
        fid = self.upload(bytes(data))
        self.chunks.append(
            {
                "file_id": fid,
                "offset": offset,
                "size": len(data),
                "mtime": time.time_ns(),
            }
        )

    def flush(self) -> list[dict]:
        """Save every remaining span; returns (and clears) the full
        accumulated chunk list for the entry commit."""
        while self.pages.intervals:
            self._save_largest(full_only=False)
        out = self.chunks
        self.chunks = []
        return out

    def dirty(self) -> bool:
        return bool(self.pages.intervals or self.chunks)
