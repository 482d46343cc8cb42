"""Declarative cluster topology specs for scale scenarios.

A spec is `dcs × racks × servers` (per rack) plus per-server volume
slots — the shape the reference expresses through docker-compose
topology files and `-dataCenter`/`-rack` flags, reduced to one frozen
dataclass so a 100-server scenario is three integers.

The port's copy of ``seaweedfs_tpu/scale/spec.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TopologySpec:
    """`data_centers × racks_per_dc × servers_per_rack` servers.

    `placement(i)` maps a flat server index to its (dc, rack) names —
    servers fill rack by rack, rack fills dc by dc, so index ranges
    map contiguously onto failure domains (killing indices
    [r*spr, (r+1)*spr) is exactly "lose rack r")."""

    data_centers: int = 5
    racks_per_dc: int = 4
    servers_per_rack: int = 5
    volumes_per_server: int = 8
    # master-tier size: 1 keeps the classic single-master harness;
    # >= 3 spawns a raft cluster (leader churn requires a quorum that
    # survives losing the leader, so the failover rounds use 3)
    masters: int = 1
    # filer-tier size: 0 keeps the classic harness (a filer only when
    # gateways need one); >= 1 spawns that many hash-partitioned
    # filer shards, each owning its own sqlite store (filer/sharding)
    filers: int = 0

    def __post_init__(self):
        if min(
            self.data_centers, self.racks_per_dc,
            self.servers_per_rack, self.volumes_per_server,
            self.masters,
        ) < 1 or self.filers < 0:
            raise ValueError(f"non-positive dimension in {self}")

    @property
    def total_servers(self) -> int:
        return (
            self.data_centers
            * self.racks_per_dc
            * self.servers_per_rack
        )

    @property
    def total_racks(self) -> int:
        return self.data_centers * self.racks_per_dc

    def placement(self, i: int) -> tuple[str, str]:
        """(dc name, rack name) for flat server index `i`. Rack names
        are globally unique (dc-qualified) so a rack filter never
        collides across dcs."""
        if not 0 <= i < self.total_servers:
            raise IndexError(i)
        rack_idx = i // self.servers_per_rack
        dc_idx = rack_idx // self.racks_per_dc
        return (
            f"dc{dc_idx + 1}",
            f"dc{dc_idx + 1}r{rack_idx % self.racks_per_dc + 1}",
        )

    def rack_indices(self, rack: int) -> list[int]:
        """Flat server indices in global rack number `rack`."""
        if not 0 <= rack < self.total_racks:
            raise IndexError(rack)
        lo = rack * self.servers_per_rack
        return list(range(lo, lo + self.servers_per_rack))

    @classmethod
    def parse(cls, spec: str, volumes_per_server: int = 8
              ) -> "TopologySpec":
        """``"5x4x5"`` → 5 dcs × 4 racks × 5 servers (100 total);
        an ``m`` suffix sizes the master tier (``"5x4x5m3"`` adds a
        3-master raft cluster) and an ``f`` suffix the sharded filer
        tier (``"5x4x5m3f4"`` adds 4 hash-partitioned filer shards)."""
        parts = spec.lower().replace("×", "x").split("x")
        if len(parts) != 3:
            raise ValueError(
                f"spec {spec!r} is not "
                "DCSxRACKSxSERVERS[mMASTERS][fFILERS]"
            )
        masters, filers = 1, 0
        last = parts[2]
        if "f" in last:
            last, _, f = last.partition("f")
            filers = int(f)
        if "m" in last:
            last, _, m = last.partition("m")
            masters = int(m)
        dcs, racks, servers = int(parts[0]), int(parts[1]), int(last)
        return cls(
            data_centers=dcs,
            racks_per_dc=racks,
            servers_per_rack=servers,
            volumes_per_server=volumes_per_server,
            masters=masters,
            filers=filers,
        )

    def __str__(self) -> str:
        base = (
            f"{self.data_centers}x{self.racks_per_dc}"
            f"x{self.servers_per_rack}"
        )
        if self.masters > 1:
            base += f"m{self.masters}"
        if self.filers > 0:
            base += f"f{self.filers}"
        return base
