"""Tiered chunk cache + singleflight for the filer read path.

Behavioral model: weed/util/chunk_cache/chunk_cache.go:16-39 (a memory
cache in front of three on-disk layers picked by chunk size) and
weed/filer/reader_at.go:18-80 (singleflight: concurrent readers of the
same chunk share ONE upstream fetch). Disk layers here are plain files
under ``<dir>/tier<i>/`` with mtime-LRU eviction per tier budget; the
reference backs them with volume files, but the contract is the same —
bounded, size-tiered, survives a restart.

Cache hits/misses are exported per tier via the prometheus registry
(``seaweedfs_chunk_cache_requests_total{result,tier}``).

The port's copy of ``seaweedfs_tpu/util/chunk_cache.py``; its counters
live in the port's own registry.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Callable

from ..stats.metrics import REGISTRY

CACHE_REQUESTS = REGISTRY.counter(
    "seaweedfs_chunk_cache_requests_total",
    "Chunk cache lookups by result (hit/miss) and serving tier",
    labels=("result", "tier"),
)
CACHE_BYTES = REGISTRY.gauge(
    "seaweedfs_chunk_cache_bytes",
    "Bytes resident per cache tier",
    labels=("tier",),
)


class SingleFlight:
    """Deduplicate concurrent calls by key: one caller runs the function,
    the rest wait for (and share) its result or exception."""

    class _Call:
        __slots__ = ("event", "result", "error")

        def __init__(self):
            self.event = threading.Event()
            self.result = None
            self.error: BaseException | None = None

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[object, SingleFlight._Call] = {}

    def do(self, key, fn: Callable[[], bytes]):
        with self._lock:
            call = self._inflight.get(key)
            if call is None:
                call = self._Call()
                self._inflight[key] = call
                leader = True
            else:
                leader = False
        if not leader:
            call.event.wait()
            if call.error is not None:
                raise call.error
            return call.result
        try:
            call.result = fn()
            return call.result
        except BaseException as e:
            call.error = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            call.event.set()


class TieredChunkCache:
    """Memory LRU in front of optional size-tiered disk layers."""

    # chunk-size ceilings per disk tier (chunk_cache.go uses 1MB / 4MB /
    # anything bigger for its three volume-backed layers)
    TIER_LIMITS = (1 << 20, 4 << 20, None)

    def __init__(
        self,
        mem_limit: int = 64 * 1024 * 1024,
        disk_dir: str | None = None,
        disk_limits: tuple[int, int, int] = (
            64 << 20,
            128 << 20,
            256 << 20,
        ),
    ):
        self.mem_limit = mem_limit
        self.disk_dir = disk_dir
        self.disk_limits = disk_limits
        self._mem: collections.OrderedDict[str, bytes] = (
            collections.OrderedDict()
        )
        self._mem_bytes = 0
        self._disk_bytes = [0, 0, 0]
        self._lock = threading.Lock()
        self.flight = SingleFlight()
        if disk_dir:
            for i in range(3):
                os.makedirs(os.path.join(disk_dir, f"tier{i}"),
                            exist_ok=True)
                self._disk_bytes[i] = sum(
                    e.stat().st_size
                    for e in os.scandir(
                        os.path.join(disk_dir, f"tier{i}")
                    )
                )
                CACHE_BYTES.set(self._disk_bytes[i], f"disk{i}")

    # -- lookup ----------------------------------------------------------

    def get(self, fid: str) -> bytes | None:
        with self._lock:
            if fid in self._mem:
                self._mem.move_to_end(fid)
                CACHE_REQUESTS.inc("hit", "mem")
                return self._mem[fid]
        if self.disk_dir:
            for i in range(3):
                path = self._disk_path(i, fid)
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                    os.utime(path)  # refresh LRU position
                    CACHE_REQUESTS.inc("hit", f"disk{i}")
                    self._put_mem(fid, data)
                    return data
                except OSError:
                    continue
        CACHE_REQUESTS.inc("miss", "none")
        return None

    def get_or_fetch(
        self, fid: str, fetch: Callable[[], bytes]
    ) -> bytes:
        """Cache lookup with singleflight miss handling: concurrent
        readers of one chunk trigger exactly one upstream fetch."""
        data = self.get(fid)
        if data is not None:
            return data

        def miss():
            inner = self.get(fid)  # a co-flier may have filled it
            if inner is not None:
                return inner
            out = fetch()
            self.put(fid, out)
            return out

        return self.flight.do(fid, miss)

    # -- insert ----------------------------------------------------------

    def put(self, fid: str, data: bytes) -> None:
        self._put_mem(fid, data)
        if self.disk_dir:
            tier = self._tier_for(len(data))
            path = self._disk_path(tier, fid)
            try:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                # A re-put may overwrite an existing cache file (racing
                # readers past singleflight, re-put after mem eviction);
                # subtract its old size so tier accounting doesn't drift.
                try:
                    old_size = os.stat(path).st_size
                except OSError:
                    old_size = 0
                os.replace(tmp, path)
            except OSError:
                return
            with self._lock:
                self._disk_bytes[tier] += len(data) - old_size
                self._evict_disk(tier)
                CACHE_BYTES.set(
                    self._disk_bytes[tier], f"disk{tier}"
                )

    def _put_mem(self, fid: str, data: bytes) -> None:
        with self._lock:
            if fid in self._mem:
                return
            self._mem[fid] = data
            self._mem_bytes += len(data)
            while self._mem_bytes > self.mem_limit and self._mem:
                _, evicted = self._mem.popitem(last=False)
                self._mem_bytes -= len(evicted)
            CACHE_BYTES.set(self._mem_bytes, "mem")

    # -- disk layers -----------------------------------------------------

    def _tier_for(self, size: int) -> int:
        for i, limit in enumerate(self.TIER_LIMITS):
            if limit is None or size <= limit:
                return i
        return 2

    def _disk_path(self, tier: int, fid: str) -> str:
        h = hashlib.sha1(fid.encode()).hexdigest()
        return os.path.join(self.disk_dir, f"tier{tier}", h)

    def _evict_disk(self, tier: int) -> None:
        """mtime-LRU eviction down to the tier budget (lock held)."""
        if self._disk_bytes[tier] <= self.disk_limits[tier]:
            return
        folder = os.path.join(self.disk_dir, f"tier{tier}")
        try:
            entries = sorted(
                os.scandir(folder), key=lambda e: e.stat().st_mtime
            )
        except OSError:
            return
        for e in entries:
            if self._disk_bytes[tier] <= self.disk_limits[tier]:
                break
            try:
                size = e.stat().st_size
                os.remove(e.path)
                self._disk_bytes[tier] -= size
            except OSError:
                continue

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._mem_bytes = 0
