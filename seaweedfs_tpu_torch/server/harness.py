"""In-process cluster harness with fault injection.

The reference needs docker-compose for multi-node tests (SURVEY §4); here
a whole master tier + N volume-server cluster runs in one process on
ephemeral ports, with kill/restart and shard-drop fault injection — the
test bed the reference never had. `n_masters >= 3` spawns a raft-lite
master cluster (server/raft.py) with a kill/restart surface, so leader
failover is as scriptable as volume churn.

The port's copy of ``seaweedfs_tpu/server/harness.py``, on the port's
master and volume servers. ``device`` goes to every ``VolumeServer``:
``None`` is the card (and raises without one, as ``VolumeServer`` does),
``"cpu"`` the kernels' plain versions. The filer and S3 tiers are not
ported yet: ``with_filer``, ``with_s3`` and ``n_filer_shards`` raise
``NotImplementedError``, and so does a ``telemetry_interval``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import resolve_device
from .master import MasterServer
from .volume import VolumeServer


class ClusterHarness:
    def __init__(
        self,
        n_volume_servers: int = 3,
        volumes_per_server: int = 8,
        pulse_seconds: float = 0.2,
        data_centers: list[str] | None = None,
        racks: list[str] | None = None,
        root: str | None = None,
        replicate_quorum: int | None = None,
        with_filer: bool = False,
        with_s3: bool = False,
        telemetry_interval: float | None = None,
        slo_error_rate: float | None = None,
        slo_p99_seconds: float | None = None,
        maintenance_policy=None,
        volume_size_limit_mb: int | None = None,
        n_masters: int = 1,
        n_filer_shards: int = 0,
        device: str | torch.device | None = None,
    ):
        if with_filer or with_s3 or n_filer_shards:
            raise NotImplementedError(
                "the filer and S3 tiers are not ported yet"
            )
        if telemetry_interval is not None:
            raise NotImplementedError(
                "the telemetry snapshot is not ported yet; pass "
                "telemetry_interval=None"
            )
        # resolved before any server starts: no card and no
        # device="cpu" raises here, with nothing left running
        self.device = resolve_device(device)
        # the /admin/fault switchboard ships disabled
        # (fault.admin_enabled); this harness IS the chaos test bed,
        # so arm it for the whole process
        os.environ.setdefault("SEAWEEDFS_FAULTS_ADMIN", "1")
        self.root = root or tempfile.mkdtemp(prefix="swtpu_cluster_")
        self._own_root = root is None
        self.pulse = pulse_seconds
        self.n_masters = max(1, n_masters)
        self.masters_down: set[int] = set()
        master_kwargs: dict = {}
        if volume_size_limit_mb is not None:
            master_kwargs["volume_size_limit_mb"] = volume_size_limit_mb
        # N-master raft cluster, wired the way tests/test_multi_master.py
        # established: construct all masters first (ports bind at
        # construction), assign the sorted peer set, then start — a
        # master started before the peer list exists would elect itself
        # in a single-node "cluster"
        self.masters: list[MasterServer] = []
        self._master_cfg: list[dict] = []
        for i in range(self.n_masters):
            cfg = dict(
                pulse_seconds=pulse_seconds,
                slo_error_rate=slo_error_rate,
                slo_p99_seconds=slo_p99_seconds,
                # autonomy tests pass an accelerated MaintenancePolicy;
                # None keeps the plane off so unrelated cluster tests
                # never see background vacuum/encode/balance churn.
                # Every master gets it: the plane is leader-gated at
                # runtime, so a new leader resumes maintenance
                maintenance_policy=maintenance_policy,
                **master_kwargs,
            )
            if self.n_masters > 1:
                # durable raft metadata (term / vote / state): a master
                # that forgets its vote across kill_master+restart
                # could vote twice in one term and elect two leaders
                cfg["state_dir"] = os.path.join(self.root, f"m{i}")
            self._master_cfg.append(cfg)
            self.masters.append(MasterServer(**cfg))
        self.master_peers = sorted(m.url for m in self.masters)
        for i, m in enumerate(self.masters):
            if self.n_masters > 1:
                m.peers = list(self.master_peers)
                # pin the port: a restarted master must come back at
                # the SAME url, or every peer list in the fleet rots
                self._master_cfg[i]["port"] = int(
                    m.url.rsplit(":", 1)[1]
                )
            m.start()
        if self.n_masters > 1:
            self.wait_for_leader(
                timeout=max(30.0, 60 * pulse_seconds)
            )
        self.volume_servers: list[VolumeServer] = []
        self._vs_config: list[dict] = []
        for i in range(n_volume_servers):
            dc = data_centers[i] if data_centers else "dc1"
            rack = racks[i] if racks else f"rack{i % 2}"
            cfg = dict(
                dirs=[os.path.join(self.root, f"vs{i}")],
                max_volume_counts=[volumes_per_server],
                data_center=dc,
                rack=rack,
                replicate_quorum=replicate_quorum,
            )
            if self.n_masters > 1:
                # the failover peer ring: heartbeats re-home to the
                # new leader via response hints, and rotate through
                # this list when the home master is plain dead
                cfg["master_peers"] = list(self.master_peers)
            self._vs_config.append(cfg)
            self.volume_servers.append(self._spawn(cfg))

    def _spawn(self, cfg: dict) -> VolumeServer:
        os.makedirs(cfg["dirs"][0], exist_ok=True)
        vs = VolumeServer(
            master_url=self.master.url,
            pulse_seconds=self.pulse,
            device=self.device,
            **cfg,
        )
        vs.start()
        return vs

    # -- master tier -----------------------------------------------------

    @property
    def master(self) -> MasterServer:
        """The current leader (the single master of a classic 1-master
        harness). Mid-election, falls back to the first live master so
        callers always get an object to poll."""
        if self.n_masters == 1:
            return self.masters[0]
        live = [
            m for i, m in enumerate(self.masters)
            if i not in self.masters_down
        ]
        for m in live:
            if m.is_leader:
                return m
        return live[0] if live else self.masters[0]

    def master_urls(self) -> list[str]:
        """Every master's URL, dead or alive — the ring clients rotate
        through (urls are port-pinned, so they survive restarts)."""
        return [m.url for m in self.masters]

    def current_leader_index(self) -> int | None:
        for i, m in enumerate(self.masters):
            if i not in self.masters_down and m.is_leader:
                return i
        return None

    def wait_for_leader(self, timeout: float = 30.0) -> MasterServer:
        """Block until exactly ONE live master holds a leased
        leadership (two would mean a split; zero, an election)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            leaders = [
                m for i, m in enumerate(self.masters)
                if i not in self.masters_down and m.is_leader
            ]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.05)
        raise TimeoutError(
            f"no unique raft leader among {self.master_urls()}"
        )

    def kill_master(self, i: int) -> None:
        if i in self.masters_down:
            return
        self.masters_down.add(i)
        self.masters[i].stop()

    def restart_master(self, i: int) -> None:
        """Respawn master `i` at its original (pinned) port; it rejoins
        the raft cluster as a follower with its durable term/vote."""
        if i not in self.masters_down:
            return
        m = MasterServer(**self._master_cfg[i])
        m.peers = list(self.master_peers)
        self.masters[i] = m
        m.start()
        self.masters_down.discard(i)

    # -- fault injection -------------------------------------------------

    def kill_volume_server(self, i: int) -> None:
        self.volume_servers[i].stop()

    def restart_volume_server(self, i: int) -> None:
        self.volume_servers[i] = self._spawn(self._vs_config[i])

    def wait_for_nodes(self, n: int, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.master.topo.data_nodes()) == n:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"expected {n} nodes, have "
            f"{len(self.master.topo.data_nodes())}"
        )

    def settle(self, pulses: float = 3) -> None:
        time.sleep(self.pulse * pulses)

    def stop(self) -> None:
        def _stop_one(vs) -> None:
            try:
                vs.stop()
            except Exception:
                pass

        # server stops are independent (each closes its own listener
        # and store); at fleet scale a sequential walk dominates test
        # teardown, so fan out
        with ThreadPoolExecutor(
            max_workers=min(16, max(1, len(self.volume_servers)))
        ) as pool:
            list(pool.map(_stop_one, self.volume_servers))
        for i, m in enumerate(self.masters):
            if i in self.masters_down:
                continue
            try:
                m.stop()
            except Exception:
                pass
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "ClusterHarness":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
