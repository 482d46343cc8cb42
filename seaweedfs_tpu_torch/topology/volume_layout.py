"""VolumeLayout: writable/readonly vid tracking per (collection, rp, ttl).

Behavioral model: weed/topology/volume_layout.go:1-440,
volume_location_list.go.

The port's copy of ``seaweedfs_tpu/topology/volume_layout.py``.
"""

from __future__ import annotations

import random
import threading

from ..pb.messages import VolumeInformationMessage
from ..storage import types as t
from .node import DataNode


class VolumeLocationList:
    def __init__(self):
        self.list: list[DataNode] = []

    def __len__(self) -> int:
        return len(self.list)

    def add(self, dn: DataNode) -> bool:
        for i, node in enumerate(self.list):
            if node.ip == dn.ip and node.port == dn.port:
                self.list[i] = dn
                return False
        self.list.append(dn)
        return True

    def remove(self, dn: DataNode) -> bool:
        for i, node in enumerate(self.list):
            if node.ip == dn.ip and node.port == dn.port:
                del self.list[i]
                return True
        return False

    def head(self) -> DataNode | None:
        return self.list[0] if self.list else None


class VolumeLayout:
    def __init__(
        self,
        rp: t.ReplicaPlacement,
        ttl: t.TTL,
        volume_size_limit: int = 30 * 1000 * 1000 * 1000,
    ):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.vid2location: dict[int, VolumeLocationList] = {}
        self.writables: list[int] = []
        self.readonly_volumes: set[int] = set()
        self.oversized_volumes: set[int] = set()
        self._lock = threading.RLock()

    # -- registration ----------------------------------------------------

    def register_volume(
        self, v: VolumeInformationMessage, dn: DataNode
    ) -> None:
        with self._lock:
            loc = self.vid2location.setdefault(
                v.id, VolumeLocationList()
            )
            loc.add(dn)
            if v.read_only:
                self.readonly_volumes.add(v.id)
            else:
                self.readonly_volumes.discard(v.id)
            if self._is_oversized(v):
                self.oversized_volumes.add(v.id)
            self._rememberOversized_and_update_writable(v)

    def _is_oversized(self, v: VolumeInformationMessage) -> bool:
        return v.size >= self.volume_size_limit

    def _rememberOversized_and_update_writable(  # weedcheck: holds[self._lock]
        self, v: VolumeInformationMessage
    ) -> None:
        writable = (
            not self._is_oversized(v)
            and not v.read_only
            and len(self.vid2location[v.id]) >= self.rp.copy_count
        )
        if writable:
            if v.id not in self.writables:
                self.writables.append(v.id)
        else:
            self.remove_from_writable(v.id)

    def unregister_volume(
        self, v: VolumeInformationMessage, dn: DataNode
    ) -> None:
        with self._lock:
            loc = self.vid2location.get(v.id)
            if loc is None:
                return
            loc.remove(dn)
            if len(loc) == 0:
                del self.vid2location[v.id]
                self.remove_from_writable(v.id)
            elif len(loc) < self.rp.copy_count:
                self.remove_from_writable(v.id)

    def remove_from_writable(self, vid: int) -> None:
        # called both from locked paths (register/unregister, RLock
        # reentrant) and bare from the maintenance vacuum executor —
        # an unlocked list.remove racing a reader's iteration corrupts
        # the rotation
        with self._lock:
            if vid in self.writables:
                self.writables.remove(vid)

    def set_volume_unavailable(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            loc = self.vid2location.get(vid)
            if loc and loc.remove(dn):
                if len(loc) < self.rp.copy_count:
                    self.remove_from_writable(vid)

    def set_volume_readonly(self, vid: int) -> None:
        with self._lock:
            self.readonly_volumes.add(vid)
            self.remove_from_writable(vid)

    def set_volume_writable(self, vid: int) -> None:
        with self._lock:
            self.readonly_volumes.discard(vid)
            if vid in self.vid2location and vid not in self.writables:
                self.writables.append(vid)

    # -- queries ---------------------------------------------------------

    def lookup(self, vid: int) -> list[DataNode]:
        loc = self.vid2location.get(vid)
        return list(loc.list) if loc else []

    def pick_for_write(
        self, rng: random.Random | None = None
    ) -> tuple[int, list[DataNode]]:
        with self._lock:
            if not self.writables:
                raise NoWritableVolumeError(
                    "no writable volumes in layout"
                )
            vid = (rng or random).choice(self.writables)
            return vid, self.lookup(vid)

    @property
    def active_volume_count(self) -> int:
        return len(self.writables)


class NoWritableVolumeError(RuntimeError):
    pass
