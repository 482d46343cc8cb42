"""Concurrency limiting + byte-rate throttling.

The port's copy of ``seaweedfs_tpu/util/limiter.py``.

Behavioral models: weed/util/limiter.go (LimitedConcurrentExecutor —
bounded concurrent request execution) and the compaction throttle in
weed/storage/volume_vacuum.go (`compactionBytePerSecond`: the scan
copier sleeps whenever it runs ahead of the configured byte rate, so
background compaction never starves foreground reads of disk
bandwidth).
"""

from __future__ import annotations

import threading
import time


class ConcurrentLimiter:
    """Bounded concurrency gate (LimitedConcurrentExecutor analog).

    Use as a context manager around the limited section:

        limiter = ConcurrentLimiter(16)
        with limiter:
            handle_request()
    """

    def __init__(self, limit: int):
        if limit <= 0:
            raise ValueError("limit must be positive")
        self.limit = limit
        self._sem = threading.BoundedSemaphore(limit)

    def __enter__(self) -> "ConcurrentLimiter":
        self._sem.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._sem.release()

    def try_acquire(self) -> bool:
        return self._sem.acquire(blocking=False)

    def release(self) -> None:
        self._sem.release()


class BytesThrottler:
    """Cap a copy loop at N bytes/second (volume_vacuum.go's
    scanVolumeFile throttle). `bytes_per_second <= 0` disables.

    Call `throttle(n)` after processing n bytes; it sleeps just long
    enough to keep the cumulative rate at or below the cap.
    """

    def __init__(self, bytes_per_second: int = 0):
        self.rate = bytes_per_second
        self._start = time.monotonic()
        self._done = 0

    def throttle(self, n: int) -> None:
        if self.rate <= 0:
            return
        self._done += n
        while True:
            ahead = self._done / self.rate - (
                time.monotonic() - self._start
            )
            if ahead <= 0:
                return
            # sleep in bounded slices (stays interruptible) but keep
            # sleeping until the FULL debt is paid — a single capped
            # sleep under-throttles large records
            time.sleep(min(ahead, 1.0))
