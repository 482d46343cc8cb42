"""Disk-backed metadata event log: segment files + bounded memory tail.

Behavioral model: weed/util/log_buffer/log_buffer.go:42-179 +
weed/filer/filer_notify.go:18 — the reference appends every metadata
mutation to a LogBuffer that flushes into date-partitioned files (stored
as chunks in seaweedfs itself) and serves subscribers by disk replay plus
the in-memory tail. Here segments are local ndjson files next to the
filer store; the memory tail is a bounded deque, so filer memory no
longer grows with mutation count and events survive a filer restart —
`filer.sync` / `filer.replicate` peers resume from their offsets with no
lost history.

Segment files are named ``meta-<first_ts_ns>.log``. Events in a segment
are in ascending ts order, so a segment can be skipped entirely when the
next segment's first ts is not newer than the requested offset.

The port's copy of ``seaweedfs_tpu/filer/log_buffer.py``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from dataclasses import dataclass
from typing import Iterable


@dataclass
class MetaEvent:
    ts_ns: int
    directory: str
    old_entry: dict | None
    new_entry: dict | None

    @property
    def is_delete(self) -> bool:
        return self.new_entry is None


class MetaLogBuffer:
    def __init__(
        self,
        dir_path: str | None = None,
        mem_events: int = 4096,
        segment_bytes: int = 4 * 1024 * 1024,
        max_segments: int = 64,
    ):
        self.dir = dir_path
        self.segment_bytes = segment_bytes
        self.max_segments = max_segments
        self._tail: collections.deque[MetaEvent] = collections.deque(
            maxlen=mem_events
        )
        self._lock = threading.Lock()
        self._active = None  # open file handle
        self._active_path: str | None = None
        self._active_size = 0
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    # -- append ----------------------------------------------------------

    def append(self, ev: MetaEvent) -> None:
        line = (
            json.dumps(
                {
                    "ts_ns": ev.ts_ns,
                    "directory": ev.directory,
                    "old_entry": ev.old_entry,
                    "new_entry": ev.new_entry,
                },
                separators=(",", ":"),
            ).encode()
            + b"\n"
        )
        with self._lock:
            self._tail.append(ev)
            if self.dir:
                if (
                    self._active is None
                    or self._active_size >= self.segment_bytes
                ):
                    self._rotate(ev.ts_ns)
                self._active.write(line)
                self._active.flush()
                self._active_size += len(line)

    def _rotate(self, first_ts: int) -> None:
        if self._active is not None:
            self._active.close()
        path = os.path.join(self.dir, f"meta-{first_ts:020d}.log")
        self._active = open(path, "ab")
        self._active_path = path
        self._active_size = os.path.getsize(path)
        segs = self._segments()
        for stale in segs[: -self.max_segments]:
            try:
                os.remove(os.path.join(self.dir, stale))
            except OSError:
                pass

    # -- read ------------------------------------------------------------

    def since(self, ts_ns: int, limit: int = 8192) -> list[MetaEvent]:
        """Events strictly after ``ts_ns``: memory tail when it covers
        the offset, disk replay otherwise."""
        with self._lock:
            tail = list(self._tail)
        if tail and (ts_ns >= tail[0].ts_ns or not self.dir):
            return [e for e in tail if e.ts_ns > ts_ns][:limit]
        if not self.dir:
            return [e for e in tail if e.ts_ns > ts_ns][:limit]
        out: list[MetaEvent] = []
        for ev in self._replay(ts_ns):
            out.append(ev)
            if len(out) >= limit:
                break
        return out

    def _replay(self, ts_ns: int) -> Iterable[MetaEvent]:
        segs = self._segments()
        starts = [self._seg_start(s) for s in segs]
        for i, seg in enumerate(segs):
            # skip a segment entirely when the NEXT segment starts at or
            # before the offset (all its events are older than that)
            if i + 1 < len(segs) and starts[i + 1] <= ts_ns:
                continue
            path = os.path.join(self.dir, seg)
            try:
                with open(path, "rb") as f:
                    for line in f:
                        try:
                            d = json.loads(line)
                        except ValueError:
                            continue  # torn tail write after a crash
                        if d["ts_ns"] > ts_ns:
                            yield MetaEvent(
                                ts_ns=d["ts_ns"],
                                directory=d["directory"],
                                old_entry=d["old_entry"],
                                new_entry=d["new_entry"],
                            )
            except OSError:
                continue

    def _segments(self) -> list[str]:
        try:
            return sorted(
                f
                for f in os.listdir(self.dir)
                if f.startswith("meta-") and f.endswith(".log")
            )
        except OSError:
            return []

    @staticmethod
    def _seg_start(name: str) -> int:
        try:
            return int(name[len("meta-") : -len(".log")])
        except ValueError:
            return 0

    def close(self) -> None:
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None
