"""Detector: scan topology + heartbeat state, emit task candidates.

Runs inside the master leader (the only process with the full
topology picture) on the plane's interval. Each round is pure
observation — no RPCs, no mutation — over the registered heartbeat
state, so a round costs microseconds even on a large cluster:

* ``vacuum``          — replica-max garbage ratio (deleted bytes /
                        size, the heartbeat mirror of
                        ``Volume.garbage_level()``) ≥ threshold; the
                        executor re-checks via /admin/vacuum/check
                        before compacting.
* ``ec_encode``       — full (≥ full_percent% of the volume size
                        limit) AND quiet (no append for
                        quiet_seconds) volumes: the
                        command_ec_encode.go predicate that feeds the
                        GF(256) codec its warm-storage work.
* ``ec_rebuild``      — EC volumes with fewer than TOTAL_SHARDS live
                        shards (and at least DATA_SHARDS to rebuild
                        from).
* ``fix_replication`` — volumes with fewer live replicas than their
                        placement demands (volume-level loss; the
                        fid-level degraded-write repair loop from the
                        resilience layer handles the finer grain).
* ``balance``         — slot-usage spread between the fullest and
                        emptiest node beyond the policy skew.

The port's copy of ``seaweedfs_tpu/maintenance/detector.py``.
"""

from __future__ import annotations

import time

from ..storage import types as t
from ..storage.erasure_coding import constants as C
from . import tasks as T


class Detector:
    """Stateless scan logic; the plane owns the loop and the policy."""

    def __init__(self, master):
        self._master = master

    def detect(self, policy, types: tuple[str, ...] | None = None,
               garbage_threshold: float | None = None) -> list[dict]:
        """One round: candidate dicts for every enabled task type (or
        the explicit `types` subset for forced runs)."""
        wanted = types if types is not None else policy.task_types
        out: list[dict] = []
        if T.VACUUM in wanted:
            out += self.vacuum_candidates(
                garbage_threshold
                if garbage_threshold is not None
                else policy.garbage_threshold
            )
        if T.EC_ENCODE in wanted:
            out += self.ec_encode_candidates(
                policy.full_percent, policy.quiet_seconds
            )
        if T.EC_REBUILD in wanted:
            out += self.ec_rebuild_candidates()
        if T.FIX_REPLICATION in wanted:
            out += self.fix_replication_candidates()
        if T.BALANCE in wanted:
            out += self.balance_candidates(policy.balance_skew)
        return out

    # -- per-type scans --------------------------------------------------

    def _volumes_by_id(self) -> dict[int, list[tuple[dict, object]]]:
        """vid → [(volume info dict, data node)] across the topology."""
        by_id: dict[int, list] = {}
        for dn in self._master.topo.data_nodes():
            for v in list(dn.volumes.values()):
                by_id.setdefault(v.id, []).append((v, dn))
        return by_id

    def vacuum_candidates(self, threshold: float) -> list[dict]:
        out = []
        for vid, replicas in self._volumes_by_id().items():
            ratios = [
                (v.deleted_byte_count / v.size) if v.size else 0.0
                for v, _dn in replicas
            ]
            worst = max(ratios)
            if worst < threshold:
                continue
            v, _ = replicas[0]
            if v.read_only:
                continue  # frozen volumes are someone else's mid-task
            out.append({
                "type": T.VACUUM,
                "volume_id": vid,
                "collection": v.collection,
                "nodes": [dn.url for _v, dn in replicas],
                "reason": (
                    f"garbage {worst:.3f} >= {threshold:.3f}"
                ),
                "detail": {"garbage_ratio": round(worst, 4)},
            })
        return out

    def ec_encode_candidates(
        self, full_percent: float, quiet_seconds: float
    ) -> list[dict]:
        topo = self._master.topo
        limit = topo.volume_size_limit
        full_at = limit * full_percent / 100.0
        now = time.time()
        ec_vids = {vid for (_col, vid) in topo.ec_shard_map}
        out = []
        for vid, replicas in self._volumes_by_id().items():
            if vid in ec_vids:
                continue  # already (being) erasure-coded
            v, _ = replicas[0]
            if v.read_only:
                continue  # mid-encode or operator-frozen
            if v.size < full_at:
                continue
            # modified_at_second is a wall epoch stamped by the VOLUME
            # SERVER and shipped in the heartbeat — cross-process
            # arithmetic must stay on the wall clock
            if now - v.modified_at_second < quiet_seconds:  # weedcheck: ignore[wall-clock-duration]
                continue
            out.append({
                "type": T.EC_ENCODE,
                "volume_id": vid,
                "collection": v.collection,
                "nodes": [dn.url for _v, dn in replicas],
                "reason": (
                    f"full ({v.size}/{limit} bytes) and quiet for "
                    f"{now - v.modified_at_second:.0f}s"  # weedcheck: ignore[wall-clock-duration]
                ),
                "detail": {"size": v.size},
            })
        return out

    def ec_rebuild_candidates(self) -> list[dict]:
        out = []
        topo = self._master.topo
        for (col, vid), locs in list(topo.ec_shard_map.items()):
            present = {
                sid
                for sid, nodes in enumerate(locs.locations)
                if nodes
            }
            if not present or len(present) >= C.TOTAL_SHARDS:
                continue
            if len(present) < C.DATA_SHARDS:
                # unrecoverable from shards alone; surface, don't loop
                continue
            holders = sorted({
                dn.url
                for nodes in locs.locations
                for dn in nodes
            })
            out.append({
                "type": T.EC_REBUILD,
                "volume_id": vid,
                "collection": col,
                "nodes": holders,
                "reason": (
                    f"{C.TOTAL_SHARDS - len(present)} of "
                    f"{C.TOTAL_SHARDS} shards missing"
                ),
                "detail": {"present": sorted(present)},
            })
        return out

    def fix_replication_candidates(self) -> list[dict]:
        out = []
        for vid, replicas in self._volumes_by_id().items():
            v, _ = replicas[0]
            rp = t.ReplicaPlacement.from_byte(v.replica_placement)
            if len(replicas) >= rp.copy_count:
                continue
            out.append({
                "type": T.FIX_REPLICATION,
                "volume_id": vid,
                "collection": v.collection,
                "nodes": [dn.url for _v, dn in replicas],
                "reason": (
                    f"{len(replicas)}/{rp.copy_count} replicas live"
                ),
                "detail": {"want": rp.copy_count,
                           "have": len(replicas)},
            })
        return out

    def balance_candidates(self, skew: float) -> list[dict]:
        nodes = self._master.topo.data_nodes()
        if len(nodes) < 2:
            return []
        ratios = sorted(
            (
                (dn.volume_count / max(1, dn.max_volume_count), dn)
                for dn in nodes
            ),
            key=lambda pair: pair[0],
        )
        low, high = ratios[0], ratios[-1]
        if high[0] - low[0] <= max(
            skew, 1.0 / max(1, low[1].max_volume_count)
        ):
            return []
        movable = set(high[1].volumes) - set(low[1].volumes)
        if not movable:
            return []
        return [{
            "type": T.BALANCE,
            "volume_id": 0,
            "collection": "",
            "nodes": [high[1].url, low[1].url],
            "reason": (
                f"slot spread {high[0]:.2f} vs {low[0]:.2f} "
                f"exceeds {skew:.2f}"
            ),
            "detail": {"from": high[1].url, "to": low[1].url},
        }]
