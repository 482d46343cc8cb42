"""Volume growth: replica-placement-aware slot search + allocation.

Behavioral model: weed/topology/volume_growth.go:74-236. The three-level
weighted pick (data center → rack → server) enforces the "xyz" spread; the
actual allocation RPC is a callable so the master server, the in-proc test
harness, and fakes all inject their own.

The port's copy of ``seaweedfs_tpu/topology/volume_growth.py``, with
one addition: a ``registered`` callback after each replica a grow
registers, which the master's assign waits on.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Callable

from ..pb.messages import VolumeInformationMessage
from ..storage import types as t
from .node import DataNode
from .topology import Topology


@dataclass
class VolumeGrowOption:
    collection: str = ""
    replica_placement: t.ReplicaPlacement = field(
        default_factory=t.ReplicaPlacement
    )
    ttl: t.TTL = field(default_factory=t.TTL)
    preferred_data_center: str = ""
    preferred_rack: str = ""
    preferred_data_node: str = ""


def find_volume_count(copy_count: int) -> int:
    """How many volumes to grow per request (volume_growth.go:30-42)."""
    return {1: 7, 2: 6, 3: 3}.get(copy_count, 1)


class PartialGrowthError(Exception):
    """Some (but not all) of a growth batch succeeded."""

    def __init__(self, grown: int, cause: Exception):
        self.grown = grown
        self.cause = cause
        super().__init__(
            f"grew {grown} volumes, then: {cause}"
        )


class VolumeGrowth:
    def __init__(
        self,
        allocate: Callable[[DataNode, int, VolumeGrowOption], None],
        rng: random.Random | None = None,
        registered: Callable[[], None] | None = None,
    ):
        """`allocate(dn, vid, option)` performs AllocateVolume on the
        target server (raises on failure); `registered()`, when given,
        is called after each replica a grow registers."""
        self._allocate = allocate
        self._rng = rng or random.Random()
        self._registered = registered
        self._lock = threading.Lock()

    def automatic_grow_by_type(
        self, option: VolumeGrowOption, topo: Topology, target_count: int = 0
    ) -> int:
        copy_count = option.replica_placement.copy_count
        if target_count == 0:
            target_count = find_volume_count(copy_count)
        return self.grow_by_count_and_type(target_count, option, topo)

    def grow_by_count_and_type(
        self, target_count: int, option: VolumeGrowOption, topo: Topology
    ) -> int:
        """Grow up to target_count volume groups. A placement failure
        partway keeps the volumes already grown and raises
        PartialGrowthError carrying both the grown count and the cause
        — each caller decides whether partial success is acceptable
        (volume_growth.go GrowByCountAndType returns count AND error
        for the same reason)."""
        with self._lock:
            counter = 0
            for _ in range(target_count):
                try:
                    counter += self._find_and_grow(topo, option)
                except Exception as e:
                    if counter == 0:
                        raise
                    raise PartialGrowthError(counter, e) from e
            return counter

    def _find_and_grow(
        self, topo: Topology, option: VolumeGrowOption
    ) -> int:
        servers = self.find_empty_slots_for_one_volume(topo, option)
        vid = topo.next_volume_id()
        self._grow(topo, vid, option, servers)
        return len(servers)

    def find_empty_slots_for_one_volume(
        self, topo: Topology, option: VolumeGrowOption
    ) -> list[DataNode]:
        """The 3-level placement search (volume_growth.go:117-213)."""
        rp = option.replica_placement

        def dc_filter(node) -> str | None:
            if (
                option.preferred_data_center
                and node.id != option.preferred_data_center
            ):
                return "not preferred data center"
            if len(node.children) < rp.diff_rack_count + 1:
                return (
                    f"only {len(node.children)} racks, need "
                    f"{rp.diff_rack_count + 1}"
                )
            need = rp.diff_rack_count + rp.same_rack_count + 1
            if node.available_space() < need:
                return f"free {node.available_space()} < {need}"
            possible_racks = sum(
                1
                for rack in node.children.values()
                if sum(
                    1
                    for n in rack.children.values()
                    if n.available_space() >= 1
                )
                >= rp.same_rack_count + 1
            )
            if possible_racks < rp.diff_rack_count + 1:
                return (
                    f"only {possible_racks} usable racks, need "
                    f"{rp.diff_rack_count + 1}"
                )
            return None

        main_dc, other_dcs = topo.pick_nodes_by_weight(
            rp.diff_data_center_count + 1, dc_filter, self._rng
        )

        def rack_filter(node) -> str | None:
            if option.preferred_rack and node.id != option.preferred_rack:
                return "not preferred rack"
            if node.available_space() < rp.same_rack_count + 1:
                return (
                    f"free {node.available_space()} < "
                    f"{rp.same_rack_count + 1}"
                )
            if len(node.children) < rp.same_rack_count + 1:
                return (
                    f"only {len(node.children)} servers, need "
                    f"{rp.same_rack_count + 1}"
                )
            possible = sum(
                1
                for n in node.children.values()
                if n.available_space() >= 1
            )
            if possible < rp.same_rack_count + 1:
                return (
                    f"only {possible} servers with a slot, need "
                    f"{rp.same_rack_count + 1}"
                )
            return None

        main_rack, other_racks = main_dc.pick_nodes_by_weight(
            rp.diff_rack_count + 1, rack_filter, self._rng
        )

        def server_filter(node) -> str | None:
            if (
                option.preferred_data_node
                and node.id != option.preferred_data_node
            ):
                return "not preferred data node"
            if node.available_space() < 1:
                return "no free slot"
            return None

        main_server, other_servers = main_rack.pick_nodes_by_weight(
            rp.same_rack_count + 1, server_filter, self._rng
        )

        servers = [main_server, *other_servers]
        for rack in other_racks:
            servers.append(rack.reserve_one_volume(self._rng))
        for dc in other_dcs:
            servers.append(dc.reserve_one_volume(self._rng))
        return servers

    def _grow(
        self,
        topo: Topology,
        vid: int,
        option: VolumeGrowOption,
        servers: list[DataNode],
    ) -> None:
        for server in servers:
            self._allocate(server, vid, option)
            vi = VolumeInformationMessage(
                id=vid,
                collection=option.collection,
                replica_placement=option.replica_placement.to_byte(),
                ttl=option.ttl.to_uint32(),
                version=t.CURRENT_VERSION,
            )
            server.add_or_update_volume(vi)
            topo._register_volume(vi, server)
            if self._registered is not None:
                self._registered()
