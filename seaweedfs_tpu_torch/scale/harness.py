"""ScaleHarness: a ClusterHarness at fleet size.

100 in-process volume servers only fit one process if the per-server
footprint is cheap: one shared replication fan-out pool instead of 16
idle threads each, throttled telemetry snapshots instead of per-pulse
histogram scans, lazy data dirs (storage/store.py skips executor
setup for empty dirs), and a slowed pulse so heartbeat fan-in stays
at the master's comfortable rate.

The port's copy of ``seaweedfs_tpu/scale/harness.py``, over the port's
``ClusterHarness``: ``device`` goes to every volume server (``None`` is
the card and raises without one, before any thread or server starts).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from .. import resolve_device
from ..server.harness import ClusterHarness
from .spec import TopologySpec


class ScaleHarness(ClusterHarness):
    """ClusterHarness spawning `spec.total_servers` volume servers
    with dc/rack placement taken from the spec.

    Defaults tuned for fleet scale: `replicate_quorum=1` (strict
    all-copies replication would burn the error-rate SLO every time
    churn kills a replica target mid-write; the repair loop re-pushes
    the missing copies), telemetry throttled to ~4 pulses, and one
    shared replicate pool, injected into every server config so it
    survives `restart_volume_server` respawns."""

    def __init__(
        self,
        spec: TopologySpec | str = TopologySpec(),
        pulse_seconds: float = 0.5,
        replicate_quorum: int | None = 1,
        telemetry_interval: float | None = None,
        replicate_workers: int = 32,
        device: str | torch.device | None = None,
        **kwargs,
    ):
        device = resolve_device(device)
        if isinstance(spec, str):
            spec = TopologySpec.parse(spec)
        self.spec = spec
        self.down: set[int] = set()
        # created before super().__init__ — the spawn loop needs it
        self._shared_replicate_pool = ThreadPoolExecutor(
            max_workers=replicate_workers,
            thread_name_prefix="scale-replicate",
        )
        placements = [
            spec.placement(i) for i in range(spec.total_servers)
        ]
        kwargs.setdefault("n_masters", spec.masters)
        # the spec's `fN` suffix spawns that many hash-partitioned
        # filer shards (filer/sharding), each with its own sqlite file
        kwargs.setdefault("n_filer_shards", spec.filers)
        super().__init__(
            n_volume_servers=spec.total_servers,
            volumes_per_server=spec.volumes_per_server,
            pulse_seconds=pulse_seconds,
            data_centers=[p[0] for p in placements],
            racks=[p[1] for p in placements],
            replicate_quorum=replicate_quorum,
            device=device,
            telemetry_interval=(
                telemetry_interval
                if telemetry_interval is not None
                else 4 * pulse_seconds
            ),
            **kwargs,
        )

    def _spawn(self, cfg: dict):
        cfg.setdefault("replicate_pool", self._shared_replicate_pool)
        return super()._spawn(cfg)

    # -- churn-facing state ----------------------------------------------

    def kill_volume_server(self, i: int) -> None:
        if i in self.down:
            return
        super().kill_volume_server(i)
        self.down.add(i)

    def restart_volume_server(self, i: int) -> None:
        super().restart_volume_server(i)
        self.down.discard(i)

    def kill_rack(self, rack: int) -> list[int]:
        """Kill every server in global rack `rack`; returns the
        indices actually killed (already-down servers skipped)."""
        killed = []
        for i in self.spec.rack_indices(rack):
            if i not in self.down:
                self.kill_volume_server(i)
                killed.append(i)
        return killed

    def live_indices(self) -> list[int]:
        return [
            i for i in range(self.spec.total_servers)
            if i not in self.down
        ]

    def live_urls(self) -> set[str]:
        """URLs of servers the harness believes alive — the
        convergence checker gates open breakers against this set
        (a breaker toward a permanently-dead server never half-opens
        because no traffic flows; that is not a convergence failure)."""
        return {
            self.volume_servers[i].url for i in self.live_indices()
        }

    def stop(self) -> None:
        super().stop()
        self._shared_replicate_pool.shutdown(wait=False)
