"""Topology tree nodes with usage counters and weighted placement picks.

Behavioral model: weed/topology/node.go:1-263, data_node.go, rack.go,
data_center.go. Counters aggregate up the tree; picks are weighted by
available volume slots.

The port's copy of ``seaweedfs_tpu/topology/node.py``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from ..pb.messages import VolumeInformationMessage


class Node:
    def __init__(self, node_id: str):
        self.id = node_id
        self.children: dict[str, "Node"] = {}
        self.parent: Optional["Node"] = None
        self.volume_count = 0
        self.active_volume_count = 0
        self.ec_shard_count = 0
        self.max_volume_count = 0
        self.max_volume_id = 0
        self._lock = threading.RLock()

    # -- tree ------------------------------------------------------------

    def link_child_node(self, node: "Node") -> "Node":
        with self._lock:
            if node.id in self.children:
                return self.children[node.id]
            self.children[node.id] = node
            node.parent = self
            self._adjust(
                node.volume_count,
                node.active_volume_count,
                node.ec_shard_count,
                node.max_volume_count,
            )
            self.adjust_max_volume_id(node.max_volume_id)
            return node

    def unlink_child_node(self, node_id: str) -> None:
        with self._lock:
            node = self.children.pop(node_id, None)
            if node:
                node.parent = None
                self._adjust(
                    -node.volume_count,
                    -node.active_volume_count,
                    -node.ec_shard_count,
                    -node.max_volume_count,
                )

    def _adjust(
        self,
        volume_delta: int,
        active_delta: int,
        ec_delta: int,
        max_delta: int,
    ) -> None:
        # counters take each node's OWN lock on the way up the tree
        # (the reference uses atomics here): the pulse POST handler
        # and the bidi stream handler can adjust the same node
        # concurrently, and += is a lost-update race without it. The
        # child lock is released before the parent's is taken, so the
        # only ordering is child->parent — no inversion is possible.
        with self._lock:
            self.volume_count += volume_delta
            self.active_volume_count += active_delta
            self.ec_shard_count += ec_delta
            self.max_volume_count += max_delta
        if self.parent:
            self.parent._adjust(
                volume_delta, active_delta, ec_delta, max_delta
            )

    def adjust_max_volume_id(self, vid: int) -> None:
        with self._lock:
            advanced = vid > self.max_volume_id
            if advanced:
                self.max_volume_id = vid
        if advanced and self.parent:
            self.parent.adjust_max_volume_id(vid)

    # -- placement -------------------------------------------------------

    def available_space(self) -> int:
        return self.max_volume_count - self.volume_count

    def pick_nodes_by_weight(
        self,
        count: int,
        filter_fn: Callable[["Node"], str | None] | None = None,
        rng: random.Random | None = None,
    ) -> tuple["Node", list["Node"]]:
        """Pick `count` distinct children weighted by available space;
        returns (main, others). filter_fn returns an error string or None.
        (node.go PickNodesByWeight)"""
        rng = rng or random
        candidates = []
        errs = []
        for node in self.children.values():
            if filter_fn is not None:
                err = filter_fn(node)
                if err is not None:
                    errs.append(f"{node.id}: {err}")
                    continue
            candidates.append(node)
        if len(candidates) < count:
            raise NoFreeSpaceError(
                f"only {len(candidates)} of {len(self.children)} nodes "
                f"eligible under {self.id}, need {count}: "
                + "; ".join(errs[:5])
            )
        picked: list[Node] = []
        pool = candidates[:]
        for _ in range(count):
            weights = [max(1, n.available_space()) for n in pool]
            chosen = rng.choices(pool, weights=weights, k=1)[0]
            pool.remove(chosen)
            picked.append(chosen)
        return picked[0], picked[1:]

    def reserve_one_volume(
        self, rng: random.Random | None = None
    ) -> "DataNode":
        """Weighted random walk down to a DataNode with a free slot
        (node.go ReserveOneVolume)."""
        rng = rng or random
        if isinstance(self, DataNode):
            if self.available_space() < 1:
                raise NoFreeSpaceError(f"no space on {self.id}")
            return self
        pool = [
            c for c in self.children.values() if c.available_space() >= 1
        ]
        if not pool:
            raise NoFreeSpaceError(f"no free slots under {self.id}")
        weights = [c.available_space() for c in pool]
        chosen = rng.choices(pool, weights=weights, k=1)[0]
        return chosen.reserve_one_volume(rng)

    @property
    def is_data_node(self) -> bool:
        return isinstance(self, DataNode)


class NoFreeSpaceError(RuntimeError):
    pass


class DataNode(Node):
    """One volume server (weed/topology/data_node.go)."""

    def __init__(self, node_id: str, ip: str = "", port: int = 0,
                 public_url: str = ""):
        super().__init__(node_id)
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.volumes: dict[int, VolumeInformationMessage] = {}
        self.ec_shards: dict[int, int] = {}  # vid → shard bits
        self.ec_collections: dict[int, str] = {}  # vid → collection
        # liveness stamp compared against a monotonic cutoff
        # (master _reap_dead_nodes); never a display value
        self.last_seen = time.monotonic()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def add_or_update_volume(
        self, v: VolumeInformationMessage
    ) -> bool:
        with self._lock:
            is_new = v.id not in self.volumes
            if is_new:
                self._adjust(1, 0 if v.read_only else 1, 0, 0)
            self.volumes[v.id] = v
            self.adjust_max_volume_id(v.id)
            return is_new

    def delete_volume_by_id(self, vid: int) -> None:
        with self._lock:
            if vid in self.volumes:
                del self.volumes[vid]
                self._adjust(-1, -1, 0, 0)

    def update_volumes(
        self, actual: list[VolumeInformationMessage]
    ) -> tuple[list, list]:
        """Full-state sync from a heartbeat → (new, deleted)."""
        actual_map = {v.id: v for v in actual}
        with self._lock:
            deleted = [
                v for vid, v in self.volumes.items()
                if vid not in actual_map
            ]
            new = [
                v for vid, v in actual_map.items()
                if vid not in self.volumes
            ]
            for v in deleted:
                self.delete_volume_by_id(v.id)
            for v in actual_map.values():
                self.add_or_update_volume(v)
            return new, deleted

    def update_ec_shards(
        self, actual: list
    ) -> tuple[list, list]:
        """Full-state EC sync → (new, deleted) shard-info deltas."""
        actual_map = {m.id: m.ec_index_bits for m in actual}
        with self._lock:
            # collection per ec volume (evacuate/balance need it to
            # address the shard files on the holder)
            self.ec_collections = {
                m.id: m.collection for m in actual if m.ec_index_bits
            }
            new, deleted = [], []
            for vid, bits in list(self.ec_shards.items()):
                now = actual_map.get(vid, 0)
                if gone := bits & ~now:
                    deleted.append((vid, gone))
            for vid, bits in actual_map.items():
                added = bits & ~self.ec_shards.get(vid, 0)
                if added:
                    new.append((vid, added))
            old_total = sum(
                bin(b).count("1") for b in self.ec_shards.values()
            )
            new_total = sum(
                bin(b).count("1") for b in actual_map.values()
            )
            self.ec_shards = {
                vid: bits for vid, bits in actual_map.items() if bits
            }
            self._adjust(0, 0, new_total - old_total, 0)
            return new, deleted


class Rack(Node):
    def new_or_get_data_node(
        self, node_id: str, ip: str, port: int, public_url: str,
        max_volume_count: int,
    ) -> DataNode:
        with self._lock:
            if node_id in self.children:
                dn = self.children[node_id]
                dn.last_seen = time.monotonic()
                return dn
            dn = DataNode(node_id, ip, port, public_url)
            dn.max_volume_count = max_volume_count
            self.link_child_node(dn)
            return dn


class DataCenter(Node):
    def get_or_create_rack(self, rack_id: str) -> Rack:
        with self._lock:
            if rack_id in self.children:
                return self.children[rack_id]
            return self.link_child_node(Rack(rack_id))
