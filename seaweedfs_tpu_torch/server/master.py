"""Master server: volume directory, assignment, growth, vacuum, EC map.

Behavioral model: weed/server/master_server.go:48-243,
master_server_handlers.go (/dir/assign,/dir/lookup,/vol/grow,...),
master_grpc_server.go (heartbeat registration + location broadcast),
weed/sequence/memory_sequencer.go (file key sequencing).

Transport: JSON over HTTP (heartbeats are POSTs on a short pulse rather
than a bidi gRPC stream; liveness = missed pulses).

The port's copy of ``seaweedfs_tpu/server/master.py``: the same routes,
statuses and bodies for heartbeats (pulse and stream), assign, lookup,
``/ec/lookup``, grow, vacuum (the async batch while the maintenance
plane runs, the synchronous walk otherwise or with ``?sync=1``), the
cluster lock, raft, ``/topology``, ``/cluster/status`` (with
``FilerShards`` once a filer shard reports), ``/cluster/watch``, the
autonomous maintenance plane (``/cluster/maintenance``) and the cluster
telemetry plane (``/cluster/telemetry``, the SLO objectives, heartbeat
snapshots), the last load round (``/cluster/benchmark``), with the
scheduled ``maintenance_scripts`` run through the port's shell.

The master registers its flight-recorder probes at start, its own
snapshot carries ``benchmark`` and ``contention``, and it routes through
the request-tracing middleware. ``/`` and ``/ui`` serve the status page
of ``server/ui.py``.
"""

from __future__ import annotations

import random
import threading
import time

from .. import fault, tracing
from ..maintenance import MaintenancePlane, MaintenancePolicy
from ..pb.messages import Heartbeat
from ..stats.metrics import REGISTRY
from ..telemetry import devices as devices_mod
from ..telemetry import recorder as flight
from ..telemetry.aggregator import ClusterTelemetry
from ..telemetry.snapshot import (
    TelemetryCollector,
    mark_started,
    metrics_response,
)
from ..storage import types as t
from ..storage.file_id import FileId
from ..topology import Topology, VolumeGrowth, VolumeGrowOption
from ..topology.volume_layout import NoWritableVolumeError
from ..util import http
from ..tracing import middleware as trace_mw
from ..util import retry as retry_mod
from ..util.http import Request, Response, Router
from . import location_watch

MASTER_HEARTBEATS = REGISTRY.counter(
    "seaweedfs_master_heartbeat_total",
    "Heartbeats applied by this process's master role.",
)


class MemorySequencer:
    """Monotonic file-key allocator (weed/sequence/memory_sequencer.go)."""

    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._counter:
                self._counter = seen + 1


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        volume_size_limit_mb: int = 30_000,
        default_replication: str = "000",
        pulse_seconds: float = 1.0,
        garbage_threshold: float = 0.3,
        jwt_signing_key: str = "",
        maintenance_scripts: list[str] | None = None,
        maintenance_interval: float = 17.0,
        maintenance_policy: MaintenancePolicy | None = None,
        peers: list[str] | None = None,
        ssl_context=None,
        state_dir: str | None = None,
        slo_error_rate: float | None = None,
        slo_p99_seconds: float | None = None,
    ):
        # Multi-master HA (raft_server.go analog): raft-lite with terms,
        # majority election, leader lease, and a replicated monotonic
        # state machine (max volume id + file-key ceiling) — see
        # server/raft.py. Followers proxy mutating calls to the leader
        # and announce it in heartbeat responses so volume servers
        # re-home. Peers may be assigned after construction (ports bind
        # lazily); the raft node is built in start().
        self.peers: list[str] = peers or []
        self.raft = None
        self.jwt_signing_key = jwt_signing_key
        # scheduled admin scripts (master.toml maintenance analog,
        # master_server.go:187-243 startAdminScripts)
        self.maintenance_scripts = maintenance_scripts or []
        self.maintenance_interval = maintenance_interval
        self._last_maintenance = 0.0
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024
        )
        self.sequencer = MemorySequencer()
        self.state_dir = state_dir
        self.default_replication = default_replication
        self.pulse_seconds = pulse_seconds
        self.garbage_threshold = garbage_threshold
        self.vg = VolumeGrowth(self._allocate_volume)
        self._grow_lock = threading.Lock()
        self._admin_lock_holder: str | None = None
        self._admin_lock_ts = 0.0
        self._lock = threading.Lock()
        # degraded-write reports from volume-server heartbeats:
        # reporter url -> fids awaiting re-replication
        self._repair_reports: dict[str, set[str]] = {}  # guarded-by: self._lock
        # KeepConnected analog: replayable location event log pushed to
        # /cluster/watch subscribers (master_grpc_server.go:173-228)
        self.locations = location_watch.LocationBroadcaster()
        # cluster telemetry plane: volume snapshots arrive inside
        # heartbeats, filer/S3 push to /cluster/telemetry, the master
        # folds its own in at read time (telemetry/aggregator.py);
        # staleness threshold scales with the pulse so a fast in-proc
        # harness flags a dead reporter quickly
        self.telemetry = ClusterTelemetry(
            slo_error_rate=slo_error_rate,
            slo_p99_seconds=slo_p99_seconds,
            stale_after=max(10 * pulse_seconds, 15.0),
            # one roll-up render per pulse serves every concurrent
            # poller; fresher reads would only re-read the same
            # heartbeat interval anyway
            view_cache_ttl=pulse_seconds,
        )
        self._telemetry_collector = TelemetryCollector("master")
        # (name, fn, kind) probes registered on the flight recorder in
        # start() and removed (by identity) in stop()
        self._recorder_probes: list[tuple] = []
        # last `weed benchmark` round: pushed via POST
        # /cluster/benchmark by the load generator, or loaded from a
        # LOAD_rNN.json on disk (SEAWEEDFS_LOAD_JSON / newest
        # LOAD_r*.json in cwd) — surfaced in the master's telemetry
        # snapshot so cluster.health shows load next to SLO burn
        self._last_benchmark: dict | None = None
        # autonomous maintenance plane (maintenance/): detector →
        # scheduler → executors, leader-resident; policy from the arg
        # or SEAWEEDFS_MAINT_* env (disabled unless opted in)
        self.maintenance = MaintenancePlane(
            self, policy=maintenance_policy
        )

        router = Router()
        fault.install_routes(router)
        router.add("GET", r"/metrics", self._handle_metrics)
        router.add(
            "GET", r"/cluster/telemetry", self._handle_cluster_telemetry
        )
        router.add(
            "POST", r"/cluster/telemetry", self._handle_cluster_telemetry
        )
        router.add(
            "GET", r"/cluster/benchmark",
            self._handle_cluster_benchmark,
        )
        router.add(
            "POST", r"/cluster/benchmark",
            self._handle_cluster_benchmark,
        )
        router.add(
            "GET", r"/cluster/maintenance",
            self._handle_cluster_maintenance,
        )
        router.add(
            "POST", r"/cluster/maintenance",
            self._handle_cluster_maintenance,
        )
        router.add("POST", r"/heartbeat", self._handle_heartbeat)
        router.add(
            "POST", r"/heartbeat/stream", self._handle_heartbeat_stream
        )
        router.add("GET", r"/dir/assign", self._handle_assign)
        router.add("POST", r"/dir/assign", self._handle_assign)
        router.add("GET", r"/dir/lookup", self._handle_lookup)
        router.add("GET", r"/dir/status", self._handle_dir_status)
        router.add("GET", r"/vol/grow", self._handle_grow)
        router.add("POST", r"/vol/grow", self._handle_grow)
        router.add("GET", r"/vol/status", self._handle_vol_status)
        router.add("POST", r"/vol/vacuum", self._handle_vacuum)
        router.add("GET", r"/vol/vacuum", self._handle_vacuum)
        router.add("GET", r"/col/delete", self._handle_col_delete)
        router.add("GET", r"/cluster/status", self._handle_cluster_status)
        router.add("GET", r"/cluster/watch", self._handle_cluster_watch)
        router.add("GET", r"/ec/lookup", self._handle_ec_lookup)
        router.add("POST", r"/cluster/lock", self._handle_lock)
        router.add("POST", r"/cluster/unlock", self._handle_unlock)
        router.add("POST", r"/raft/vote", self._handle_raft_vote)
        router.add("POST", r"/raft/append", self._handle_raft_append)
        router.add("GET", r"/topology", self._handle_topology)
        router.add("GET", r"/(ui)?", self._handle_ui)
        self.server = http.HttpServer(
            trace_mw.instrument(router, "master"),
            host, port, ssl_context=ssl_context,
        )
        self._reaper = threading.Thread(
            target=self._reap_dead_nodes, daemon=True
        )
        self._running = False

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        from .raft import RaftLite, RaftSequencer

        self._running = True
        self.server.start()
        mark_started("master")
        self._telemetry_collector.url = self.url
        self.raft = RaftLite(
            self.url, self.peers, pulse_seconds=self.pulse_seconds,
            state_dir=self.state_dir,
        )
        if self.peers and len(self.raft.cluster) > 1:
            self.sequencer = RaftSequencer(self.raft)
            self.topo.vid_committer = self._commit_vid
        self.raft.start()
        self._reaper.start()
        self.maintenance.start()
        self._register_recorder_probes()

    def _register_recorder_probes(self) -> None:
        """Attach the master's fleet-critical signals to the flight
        recorder: each is a cheap closure the sampler thread calls
        with no recorder lock held."""

        def agg_lock_wait_ms() -> float:
            return 1e3 * self.telemetry.probe_lock_wait_seconds()

        def heartbeats() -> float:
            return sum(MASTER_HEARTBEATS.values().values())

        def broadcast_log() -> float:
            return float(self.locations.size())

        def maint_queue() -> float:
            m = self.maintenance.telemetry()
            return float(m.get("queued", 0) + m.get("running", 0))

        def repair_backlog() -> float:
            with self._lock:
                return float(sum(
                    len(v) for v in self._repair_reports.values()
                ))

        def breakers_open() -> float:
            return float(sum(
                1 for b in retry_mod.BREAKERS.snapshot().values()
                if b.get("state") != "closed"
            ))

        def fleet_ec_gbps() -> float:
            return self.telemetry.fleet_ec_gbps()

        def raft_term() -> float:
            # term bumps ARE the election timeline: a leader-kill
            # round's flight record shows the step the moment a
            # candidate campaigns (0.0 = single-master, no raft)
            return float(self.raft.term) if self.raft else 0.0

        self._recorder_probes = [
            ("master_agg_lock_wait_ms", agg_lock_wait_ms, "gauge"),
            ("heartbeat_hz", heartbeats, "counter"),
            ("broadcast_log", broadcast_log, "gauge"),
            ("maint_queue", maint_queue, "gauge"),
            ("repair_backlog", repair_backlog, "gauge"),
            ("breakers_open", breakers_open, "gauge"),
            ("fleet_ec_gbps", fleet_ec_gbps, "gauge"),
            ("raft_term", raft_term, "gauge"),
        ]
        for name, fn, kind in self._recorder_probes:
            flight.RECORDER.register_probe(name, fn, kind)

    def stop(self) -> None:
        self._running = False
        # detach by identity: a NEW master's probe under the same name
        # must survive this (old) instance's teardown
        for name, fn, _kind in self._recorder_probes:
            flight.RECORDER.remove_probe(name, fn)
        self._recorder_probes = []
        self.maintenance.stop()
        if self.raft is not None:
            self.raft.stop()
        self.server.stop()

    def _reap_dead_nodes(self) -> None:
        while self._running:
            time.sleep(self.pulse_seconds)
            if not self.is_leader:
                continue
            # last_seen is a monotonic stamp (topology/node.py)
            deadline = time.monotonic() - 5 * self.pulse_seconds
            for dn in self.topo.data_nodes():
                if dn.last_seen < deadline:
                    self.topo.unregister_data_node(dn)
                    self.telemetry.forget(dn.url)
                    # a dead reporter can't re-push its degraded fids
                    # — keeping its report would hammer the dead URL
                    # every round and hold the backlog open forever;
                    # volume-level gaps it leaves behind are the
                    # fix_replication detector's job
                    with self._lock:
                        self._repair_reports.pop(dn.url, None)
                    self.locations.publish(
                        location_watch.node_down_event(dn)
                    )
            # bounded telemetry memory: pushed reporters (filer/S3)
            # have no heartbeat to reap, so the store evicts on a
            # staleness horizon every pulse
            self.telemetry.evict_stale()
            self._run_repair_round()
            self._maybe_run_maintenance()

    def _run_repair_round(self, per_reporter: int = 32) -> None:
        """Drive re-replication of reported degraded writes: once a
        fid's volume has any replica peer registered again, ask the
        reporting server to re-push it (/admin/repair). The reporter
        checks the achieved copies against the volume's replica
        placement: a push that lands on every registered peer but
        still falls short of copy_count comes back `pending` and stays
        queued here AND on the reporter (which keeps re-announcing the
        fid in every heartbeat), so a 2/3-replicated fid is retried
        until the last replica registers — only a terminal outcome
        (fully repaired, or fid/volume gone) drops it."""
        with self._lock:
            reports = {
                url: sorted(fids)[:per_reporter]
                for url, fids in self._repair_reports.items()
            }
        for reporter, fids in reports.items():
            for fid in fids:
                try:
                    vid = int(fid.split(",")[0])
                except ValueError:
                    continue
                if len(self.topo.lookup("", vid)) < 2:
                    continue  # no replica peer has returned yet
                try:
                    out = http.post_json(
                        f"{reporter}/admin/repair", {"fid": fid},
                        timeout=30, retry=retry_mod.LOOKUP,
                    )
                except http.HttpError:
                    continue
                if out.get("ok") and not out.get("pending"):
                    with self._lock:
                        fids_left = self._repair_reports.get(reporter)
                        if fids_left is not None:
                            fids_left.discard(fid)
                            if not fids_left:
                                self._repair_reports.pop(reporter)

    # -- leadership (raft-lite, server/raft.py) --------------------------

    @property
    def is_leader(self) -> bool:
        if self.raft is None:  # not started: unit tests drive directly
            return True
        return self.raft.is_leader()

    def _leader_warming(self) -> bool:
        """True inside the first pulses of a multi-master leadership:
        node state lives only in heartbeats, so a just-elected leader
        under-reports the fleet until every survivor re-homes (the
        reap window is 5 pulses; double it for election jitter).
        Single-master clusters never warm — their topology was never
        rebuilt from scratch mid-flight."""
        if self.raft is None or len(self.raft.cluster) == 1:
            return False
        since = self.raft.leader_since
        return bool(since) and (
            time.monotonic() - since < 10 * self.pulse_seconds
        )

    def leader(self) -> str:
        if self.raft is None:
            return self.url
        return self.raft.leader() or self.url

    def _commit_vid(self, candidate: int) -> int:
        """Commit a new max volume id through consensus (the
        MaxVolumeIdCommand analog). Raises NoQuorumError on a minority
        partition, aborting the growth."""
        vid = max(candidate, self.raft.state["max_volume_id"] + 1)
        self.raft.propose(max_volume_id=vid)
        return vid

    def _proxy_to_leader(self, req: Request) -> Response:
        """Forward a request to the leader (master_server.go:155-186)."""
        leader = self.leader()
        if leader == self.url:
            # we are not leader yet believe we are the best hint —
            # either no leader is known or our lease expired: refuse
            # rather than proxy-loop to ourselves
            return Response.error(
                "no leader (election in progress or no quorum)", 503
            )
        qs = "&".join(
            f"{k}={v}" for k, vs in req.query.items() for v in vs
        )
        url = f"{leader}{req.path}" + (f"?{qs}" if qs else "")
        try:
            body = http.request(req.method, url, req.body or None)
            return Response(status=200, body=body)
        except http.HttpError as e:
            return Response(status=e.status or 502, body=e.body)

    def _handle_raft_vote(self, req: Request) -> Response:
        if self.raft is None:
            return Response.error("raft not running", 503)
        try:
            return Response.json(self.raft.handle_vote(req.json()))
        except http.HttpError as e:
            return Response(status=e.status, body=e.body)

    def _handle_raft_append(self, req: Request) -> Response:
        if self.raft is None:
            return Response.error("raft not running", 503)
        try:
            return Response.json(self.raft.handle_append(req.json()))
        except http.HttpError as e:
            return Response(status=e.status, body=e.body)

    def _maybe_run_maintenance(self) -> None:
        if not self.maintenance_scripts:
            return
        now = time.monotonic()
        if now - self._last_maintenance < self.maintenance_interval:
            return
        self._last_maintenance = now
        from ..shell import CommandEnv, run_command

        env = CommandEnv(self.url)
        try:
            env.lock()
            for line in self.maintenance_scripts:
                try:
                    run_command(env, line)
                except Exception:
                    pass
        except Exception:
            pass
        finally:
            try:
                env.unlock()
            except Exception:
                pass

    # -- growth plumbing -------------------------------------------------

    def _allocate_volume(self, dn, vid: int, option: VolumeGrowOption):
        http.post_json(
            f"{dn.url}/admin/assign_volume",
            {
                "volume": vid,
                "collection": option.collection,
                "replication": str(option.replica_placement),
                "ttl": str(option.ttl),
            },
            timeout=30,
        )

    # -- handlers --------------------------------------------------------

    def _handle_metrics(self, req: Request) -> Response:
        return metrics_response()

    def _handle_cluster_telemetry(self, req: Request) -> Response:
        """GET: the aggregated cluster view (per-server snapshots +
        SLO burn; `?sloErrorRate=`/`?sloP99=` override the objectives
        for this read). POST: the snapshot intake for servers without
        a heartbeat (filer, S3)."""
        tracing.set_op("cluster.telemetry")
        if req.method == "POST":
            snap = req.json()
            if not isinstance(snap, dict) or not snap.get("component"):
                return Response.error(
                    "telemetry snapshot must carry 'component'", 400
                )
            self.telemetry.ingest(snap)
            return Response.json({"ok": True})

        def _param_float(name: str) -> float | None:
            raw = req.param(name)
            try:
                return float(raw) if raw else None
            except ValueError:
                return None

        return Response.json(
            self.telemetry.view_cached(
                self._build_own_snapshot,
                slo_error_rate=_param_float("sloErrorRate"),
                slo_p99_seconds=_param_float("sloP99"),
            )
        )

    def _build_own_snapshot(self) -> dict:
        """The master's own telemetry row, built per view render (the
        view cache calls this only on a miss)."""
        own = self._telemetry_collector.collect()
        # maintenance state rides the master's own snapshot so
        # cluster.health can print the queue/backlog picture without
        # another endpoint round-trip
        own["maintenance"] = self.maintenance.telemetry()
        # degraded-write repair backlog: the scale plane's convergence
        # checker polls this to zero before calling the cluster healed
        with self._lock:
            own["repair_backlog"] = {
                "reporters": len(self._repair_reports),
                "fids": sum(
                    len(v) for v in self._repair_reports.values()
                ),
            }
        bench = self._benchmark_summary()
        if bench is not None:
            own["benchmark"] = bench
        # the per-chip dispatch ledger's compact summary rides the
        # snapshot like maintenance/benchmark: cluster.health prints a
        # devices: line when busy imbalance crosses the threshold
        dev = devices_mod.LEDGER.summary()
        if dev is not None:
            own["devices"] = dev
        # top contended lock sites ride the snapshot so cluster.health
        # can flag a melting lock without another endpoint round-trip
        top = flight.contention_table(top=3)
        if top:
            own["contention"] = [
                {
                    "site": r["site"],
                    "blocked": r["blocked"],
                    "p99_wait_s": r["p99_wait_s"],
                    "total_wait_s": r["total_wait_s"],
                }
                for r in top
            ]
        return own

    def _handle_cluster_benchmark(self, req: Request) -> Response:
        """POST: `weed benchmark` pushes its round summary here after a
        run; GET: the last known round (pushed or file-loaded)."""
        tracing.set_op("cluster.benchmark")
        if req.method == "POST":
            result = req.json()
            if not isinstance(result, dict) or not isinstance(
                result.get("value"), (int, float)
            ):
                return Response.error(
                    "benchmark summary must carry a numeric 'value'",
                    400,
                )
            entry = dict(result)
            entry["received_at"] = time.time()
            entry["source"] = "push"
            self._last_benchmark = entry
            return Response.json({"ok": True})
        return Response.json(
            {"benchmark": self._benchmark_summary()}
        )

    def _benchmark_summary(self) -> dict | None:
        """The last load round's headline numbers: the pushed result
        when a `weed benchmark` reported in, else the newest
        LOAD_r*.json beside the process (SEAWEEDFS_LOAD_JSON
        overrides), else None."""
        result = self._last_benchmark
        source = "push"
        if result is None:
            import glob
            import os

            path = os.environ.get("SEAWEEDFS_LOAD_JSON", "")
            if not path:
                rounds = sorted(glob.glob("LOAD_r*.json"))
                path = rounds[-1] if rounds else ""
            if not path:
                return None
            from ..util import benchgate

            try:
                result = benchgate.load_round(path)
            except (OSError, ValueError):
                return None
            source = os.path.basename(path)
        phases = (result.get("detail") or {}).get("phases") or {}
        p99 = max(
            (
                s.get("p99_ms", 0.0)
                for s in phases.values()
                if isinstance(s, dict)
            ),
            default=0.0,
        )
        failures = sum(
            s.get("failures", 0)
            for s in phases.values()
            if isinstance(s, dict)
        )
        summary = {
            "ops_per_second": result.get("value", 0.0),
            "p99_ms": p99,
            "failures": failures,
            "phases": sorted(phases),
            "source": result.get("source", source),
            "received_at": result.get("received_at"),
        }
        # persona rounds push per-protocol golden signals; a compact
        # block rides the summary so cluster.health can show every
        # front door even when the load ran in another process (the
        # LIVE view.protocols section only sees in-proc personas)
        protocols = (result.get("detail") or {}).get("protocols")
        if isinstance(protocols, dict) and protocols:
            summary["protocols"] = {
                name: {
                    "ops_s": sec.get("ops_s", 0.0),
                    "p99_s": sec.get("p99_s", 0.0),
                    "error_rate": sec.get("error_rate", 0.0),
                }
                for name, sec in sorted(protocols.items())
                if isinstance(sec, dict)
            }
        return summary

    def _not_leader_response(self) -> dict:
        # tell the volume server where the leader is; it re-homes
        # (leader=None when no leader is known — the volume server
        # then rotates through its peer list)
        hint = self.leader()
        return {
            "volume_size_limit": self.topo.volume_size_limit,
            "leader": hint if hint != self.url else None,
            "is_leader": False,
        }

    def _apply_heartbeat(self, hb: Heartbeat) -> dict:
        """Register one heartbeat and broadcast its location delta;
        shared by the pulse POST and the bidi stream
        (master_grpc_server.go:20-170)."""
        MASTER_HEARTBEATS.inc()
        dn = self.topo.register_data_node(hb)
        full_sync = bool(hb.volumes or hb.has_no_volumes)
        if full_sync:
            self.topo.sync_data_node_registration(hb, dn)
        else:
            self.topo.incremental_sync_data_node(hb, dn)
        if hb.ec_shards or hb.has_no_ec_shards:
            self.topo.sync_data_node_ec_shards(hb.ec_shards, dn)
        else:
            for m in hb.new_ec_shards:
                self.topo.register_ec_shards(m, dn)
            for m in hb.deleted_ec_shards:
                self.topo.unregister_ec_shards(m, dn)
        self.sequencer.set_max(hb.max_file_key)
        # telemetry piggyback: the volume server's snapshot rides the
        # pulse it already pays for (telemetry/snapshot.py)
        if hb.telemetry:
            snap = dict(hb.telemetry)
            snap.setdefault("url", dn.url)
            self.telemetry.ingest(snap)
        # degraded-write intake: the reporter re-announces its full
        # under-replicated set every pulse, so this map self-corrects
        with self._lock:
            if hb.under_replicated:
                self._repair_reports[dn.url] = set(hb.under_replicated)
            else:
                self._repair_reports.pop(dn.url, None)
        # push the location change to connected watchers BEFORE the
        # heartbeat response returns (KeepConnected broadcast)
        ev = location_watch.heartbeat_delta(hb, dn, full_sync)
        if ev is not None:
            self.locations.publish(ev)
        return {
            "volume_size_limit": self.topo.volume_size_limit,
            "leader": self.url,
        }

    def _handle_heartbeat(self, req: Request) -> Response:
        if not self.is_leader:
            return Response.json(self._not_leader_response())
        hb = Heartbeat.from_dict(req.json())
        return Response.json(self._apply_heartbeat(hb))

    def _handle_heartbeat_stream(self, req: Request) -> Response:
        """Bidi heartbeat stream over one HTTP/1.1 connection — the
        SendHeartbeat stream analog (master_grpc_server.go:20): the
        volume server writes ndjson heartbeats up the chunked request
        body; each is applied as it arrives and answered with one
        ndjson line down the chunked response. Losing the connection
        IS the liveness signal, exactly like the reference's broken
        gRPC stream."""
        import json as json_mod

        # a silently-dead peer (no FIN) must not leak this handler
        # thread forever: a read deadline of several pulses ends the
        # stream, exactly the keepalive/deadline role gRPC plays for
        # the reference's bidi stream
        conn = getattr(req, "connection", None)
        if conn is not None:
            conn.settimeout(max(10 * self.pulse_seconds, 10.0))

        def gen():
            buf = b""
            while self._running:
                while b"\n" not in buf:
                    piece = req.reader.read(65536)
                    if not piece:
                        return  # stream closed: node will be reaped
                    buf += piece
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                if not self.is_leader:
                    yield (
                        json_mod.dumps(
                            self._not_leader_response()
                        ) + "\n"
                    ).encode()
                    return  # end stream; the client re-homes
                hb = Heartbeat.from_dict(json_mod.loads(line))
                out = self._apply_heartbeat(hb)
                yield (json_mod.dumps(out) + "\n").encode()

        return Response(
            status=200,
            stream=gen(),
            headers={"Content-Type": "application/x-ndjson"},
        )

    def _handle_assign(self, req: Request) -> Response:
        tracing.set_op("assign")
        if not self.is_leader:
            return self._proxy_to_leader(req)
        count = int(req.param("count", "1"))
        collection = req.param("collection")
        replication = req.param("replication") or self.default_replication
        ttl = req.param("ttl")
        option = VolumeGrowOption(
            collection=collection,
            replica_placement=t.ReplicaPlacement.parse(replication),
            ttl=t.TTL.parse(ttl),
            preferred_data_center=req.param("dataCenter"),
        )
        layout = self.topo.get_volume_layout(
            collection, option.replica_placement, option.ttl
        )
        grow_err: Exception | None = None
        with self._grow_lock:
            if layout.active_volume_count == 0:
                try:
                    self.vg.automatic_grow_by_type(option, self.topo)
                except Exception as e:
                    # a PARTIAL grow (fewer free slots than the target
                    # growth count) may still have produced writable
                    # volumes — the assign must use them; only a grow
                    # that yielded nothing writable is fatal
                    # (master_server_handlers.go:96-137 retries
                    # PickForWrite after growth errors the same way)
                    grow_err = e
        try:
            vid, locations = layout.pick_for_write()
        except NoWritableVolumeError as e:
            if not self.topo.data_nodes() or (
                grow_err is not None and self._leader_warming()
            ):
                # node state lives only in heartbeats, so a freshly
                # elected leader serves an EMPTY (or partial)
                # topology until the fleet re-homes — that's
                # "warming up", not "no capacity": answer 503 with a
                # Retry-After of one pulse so master rings and retry
                # policies ride the gap out instead of surfacing a
                # fatal grow error mid-failover
                resp = Response.error(
                    "volume servers still re-homing "
                    "(heartbeats pending)", 503,
                )
                resp.headers["Retry-After"] = str(self.pulse_seconds)
                return resp
            if grow_err is not None:
                return Response.error(
                    f"cannot grow volume group: {grow_err}", 500
                )
            return Response.error(str(e), 404)
        from .raft import NoQuorumError

        try:
            key = self.sequencer.next_file_id(count)
        except NoQuorumError as e:
            return Response.error(f"no quorum: {e}", 503)
        # batched assign (upstream's `n` count param): one round-trip
        # reserves `count` consecutive keys on the SAME volume, each
        # with its own cookie, so a load generator at scale pays one
        # master call per batch instead of one per fid
        fids = [
            str(FileId(vid, key + i, random.getrandbits(32)))
            for i in range(count)
        ]
        dn = locations[0]
        out = {
            "fid": fids[0],
            "url": dn.url,
            "publicUrl": dn.public_url,
            "count": count,
        }
        if count > 1:
            out["fids"] = fids
        if self.jwt_signing_key:
            from ..security import gen_jwt

            out["auth"] = gen_jwt(self.jwt_signing_key, fids[0])
            if count > 1:
                out["auths"] = [
                    gen_jwt(self.jwt_signing_key, f) for f in fids
                ]
        return Response.json(out)

    def _handle_lookup(self, req: Request) -> Response:
        tracing.set_op("lookup")
        if not self.is_leader:
            return self._proxy_to_leader(req)
        vid_str = req.param("volumeId")
        if "," in vid_str:  # allow full fid
            vid_str = vid_str.split(",")[0]
        collection = req.param("collection")
        try:
            vid = int(vid_str)
        except ValueError:
            return Response.error(f"bad volumeId {vid_str!r}", 400)
        locations = self.topo.lookup(collection, vid)
        if not locations:
            # EC volumes are located too (any node with a shard serves)
            ec = self.topo.lookup_ec_shards(vid, collection)
            if ec:
                nodes = {
                    dn.id: dn
                    for lst in ec.locations
                    for dn in lst
                }
                locations = list(nodes.values())
        if not locations:
            return Response.error(
                f"volume id {vid} not found", 404
            )
        return Response.json(
            {
                "volumeId": vid_str,
                "locations": [
                    {"url": dn.url, "publicUrl": dn.public_url}
                    for dn in locations
                ],
            }
        )

    def _handle_ec_lookup(self, req: Request) -> Response:
        vid = int(req.param("volumeId"))
        locs = self.topo.lookup_ec_shards(vid, req.param("collection"))
        if locs is None:
            if not self.is_leader:
                # a follower may simply not have seen the shards yet
                return self._proxy_to_leader(req)
            return Response.error(f"ec volume {vid} not found", 404)
        return self._topology_read(
            req,
            {
                "volumeId": vid,
                "shards": {
                    str(sid): [
                        {"url": dn.url, "publicUrl": dn.public_url}
                        for dn in nodes
                    ]
                    for sid, nodes in enumerate(locs.locations)
                    if nodes
                },
            },
        )

    def _handle_grow(self, req: Request) -> Response:
        if not self.is_leader:
            return self._proxy_to_leader(req)
        count = int(req.param("count", "0"))
        replication = req.param("replication") or self.default_replication
        option = VolumeGrowOption(
            collection=req.param("collection"),
            replica_placement=t.ReplicaPlacement.parse(replication),
            ttl=t.TTL.parse(req.param("ttl")),
            preferred_data_center=req.param("dataCenter"),
        )
        from ..topology.volume_growth import PartialGrowthError

        try:
            grown = self.vg.automatic_grow_by_type(
                option, self.topo, count
            )
        except PartialGrowthError as e:
            # an explicit admin grow must SURFACE the shortfall, not
            # silently under-deliver (the reference returns the grown
            # count alongside the error)
            return Response.json(
                {"count": e.grown, "error": str(e.cause)}
            )
        except Exception as e:
            return Response.error(str(e), 500)
        return Response.json({"count": grown})

    def _topology_read(self, req: Request, payload: dict) -> Response:
        """Admin topology reads answer from the leader's view: a
        follower proxies to the leader (master_server.go:155-186); if
        the leader is unreachable (partition) the local answer is served
        with an explicit "stale": true marker so operators and tools can
        tell a partitioned follower's snapshot from the live view."""
        if self.is_leader:
            return Response.json(payload)
        proxied = self._proxy_to_leader(req)
        if proxied.status == 200:
            return proxied
        return Response.json({**payload, "stale": True})

    def _handle_vol_status(self, req: Request) -> Response:
        return self._topology_read(
            req,
            {"Version": "seaweedfs-tpu", **self.topo.to_topology_info()},
        )

    def _handle_dir_status(self, req: Request) -> Response:
        return self._topology_read(req, self.topo.to_topology_info())

    def _handle_topology(self, req: Request) -> Response:
        return self._topology_read(req, self.topo.to_topology_info())

    def _handle_ui(self, req: Request) -> Response:
        from . import ui

        return Response(
            status=200,
            body=ui.master_ui(
                self.topo.to_topology_info(), self.url
            ).encode(),
            headers={"Content-Type": "text/html"},
        )

    def _handle_cluster_watch(self, req: Request) -> Response:
        """Streaming location push (KeepConnected over HTTP): one JSON
        event per line, blank-line keepalives every pulse. `since=N`
        replays the bounded event log; if N has been evicted the stream
        opens with {"reset": true} telling the watcher to drop its map
        and resync (master_grpc_server.go:173-228)."""
        if not self.is_leader:
            # watchers follow the leader; hand them the address
            hint = self.leader()
            return Response.json(
                {
                    "error": "not leader",
                    "leader": hint if hint != self.url else None,
                },
                status=503,
            )
        since = int(req.param("since", "0"))
        client_epoch = req.param("epoch", "")
        import json as json_mod

        def reset_line():
            return (
                json_mod.dumps(
                    {
                        "reset": True,
                        "epoch": self.locations.epoch,
                        # watchers cache these to find the next leader
                        # after a failover (masterclient.go:57-80)
                        "peers": self.peers or [self.url],
                    }
                ) + "\n"
            ).encode()

        def gen():
            last = since
            # epoch handshake: a watcher from a previous leader (or a
            # since= that fell off the bounded log) must drop its map
            # and replay this broadcaster's log from the start
            if client_epoch != self.locations.epoch:
                yield reset_line()
                last = 0
                events, _ = self.locations.since(0)
            else:
                events, contiguous = self.locations.since(last)
                if not contiguous:
                    yield reset_line()
                    last = 0
                    events, _ = self.locations.since(0)
            while self._running:
                for s, ev in events:
                    last = s
                    yield (
                        json_mod.dumps({"seq": s, **ev}) + "\n"
                    ).encode()
                self.locations.wait(last, self.pulse_seconds)
                events, contiguous = self.locations.since(last)
                if not contiguous:
                    # fell >capacity behind mid-stream: reset in-band
                    yield reset_line()
                    last = 0
                    events, _ = self.locations.since(0)
                elif not events:
                    # keepalive; also surfaces broken pipes so the
                    # handler thread exits with the client
                    yield b"\n"

        return Response(
            status=200,
            stream=gen(),
            headers={"Content-Type": "application/x-ndjson"},
        )

    def _handle_cluster_status(self, req: Request) -> Response:
        out = {
            "IsLeader": self.is_leader,
            "Leader": self.leader(),
            "Peers": self.peers,
        }
        # sharded filer tier, when one reports: the ordered shard URL
        # list clients (FilerRing) re-resolve from — the filer analog
        # of the leader pointer above
        shards = self.telemetry.filer_shards()
        if shards:
            out["FilerShards"] = shards
        return Response.json(out)

    def _handle_col_delete(self, req: Request) -> Response:
        name = req.param("collection")
        col = self.topo.collections.get(name)
        if col:
            vids = set()
            for layout in col.layouts():
                vids.update(layout.vid2location.keys())
            for dn in self.topo.data_nodes():
                for vid in vids & set(dn.volumes.keys()):
                    try:
                        http.post_json(
                            f"{dn.url}/admin/delete_volume",
                            {"volume": vid},
                        )
                    except http.HttpError:
                        pass
        self.topo.delete_collection(name)
        return Response.json({"deleted": name})

    # -- maintenance plane control surface -------------------------------

    def _handle_cluster_maintenance(self, req: Request) -> Response:
        """GET: the plane's live view (queue, running, history ring,
        policy, gate state; `?batch=` filters to one async-vacuum
        batch). POST: control actions — pause / resume / run [type] /
        policy {updates}."""
        tracing.set_op("cluster.maintenance")
        if not self.is_leader:
            return self._proxy_to_leader(req)
        plane = self.maintenance
        if req.method == "GET":
            return Response.json(
                plane.view(batch=req.param("batch") or None)
            )
        body = req.json()
        action = body.get("action", "")
        if action == "pause":
            plane.pause()
            return Response.json({"ok": True, "paused": True})
        if action == "resume":
            plane.resume()
            return Response.json({"ok": True, "paused": False})
        if action == "run":
            # forced detector round, optionally one task type; works
            # even while the plane is disabled (operator-driven)
            task_type = body.get("type") or None
            from ..maintenance.tasks import TASK_TYPES

            if task_type is not None and task_type not in TASK_TYPES:
                return Response.error(
                    f"unknown task type {task_type!r} "
                    f"(want one of {list(TASK_TYPES)})", 400
                )
            types = (task_type,) if task_type else None
            plane.ensure_workers()
            accepted = plane.run_round(types=types)
            plane.scheduler.wake()
            return Response.json(
                {"ok": True,
                 "enqueued": [t.to_dict() for t in accepted]}
            )
        if action == "policy":
            updates = body.get("policy") or {}
            try:
                policy = plane.update_policy(updates)
            except ValueError as e:
                return Response.error(str(e), 400)
            return Response.json(
                {"ok": True, "policy": policy.to_dict()}
            )
        return Response.error(f"unknown action {action!r}", 400)

    # -- vacuum orchestration (topology_vacuum.go) -----------------------

    def _handle_vacuum(self, req: Request) -> Response:
        if not self.is_leader:
            return self._proxy_to_leader(req)
        threshold = float(
            req.param("garbageThreshold") or self.garbage_threshold
        )
        # forwarded to every compact (the -compactionBytePerSecond
        # throttle, volume_vacuum.go) so cluster-wide vacuum can be
        # rate-capped from one place
        byte_rate = int(req.param("compactionBytePerSecond") or "0")
        # async by default when the plane is running: enqueue
        # per-volume maintenance tasks and answer immediately with a
        # batch id (`maintenance.status` / GET /cluster/maintenance
        # show progress); `?sync=1` keeps the walk-the-cluster
        # behavior for tests and operators who want to block
        if self.maintenance.active and req.param("sync") != "1":
            batch, accepted = self.maintenance.enqueue_vacuum_batch(
                threshold, byte_rate
            )
            return Response.json({
                "async": True,
                "batch": batch,
                "enqueued": [t.volume_id for t in accepted],
            })
        vacuumed = []
        for col in list(self.topo.collections.values()):
            for layout in col.layouts():
                for vid, loc in list(layout.vid2location.items()):
                    urls = [dn.url for dn in loc.list]
                    if not urls:
                        continue
                    try:
                        ratios = [
                            http.post_json(
                                f"{u}/admin/vacuum/check",
                                {"volume": vid},
                            )["garbage_ratio"]
                            for u in urls
                        ]
                    except http.HttpError:
                        continue
                    if min(ratios) < threshold:
                        continue
                    layout.remove_from_writable(vid)
                    try:
                        for u in urls:
                            http.post_json(
                                f"{u}/admin/vacuum/compact",
                                {
                                    "volume": vid,
                                    "compaction_byte_per_second":
                                        byte_rate,
                                },
                                timeout=600,
                            )
                        for u in urls:
                            http.post_json(
                                f"{u}/admin/vacuum/commit",
                                {"volume": vid},
                                timeout=600,
                            )
                        vacuumed.append(vid)
                    finally:
                        layout.set_volume_writable(vid)
        return Response.json({"vacuumed": vacuumed})

    # -- cluster admin lock (wdclient/exclusive_locks analog) ------------

    def _handle_lock(self, req: Request) -> Response:
        client = req.json().get("client", "unknown")
        with self._lock:
            # lease freshness is a duration: monotonic clock (the
            # maintenance plane compares against the same stamp)
            now = time.monotonic()
            if (
                self._admin_lock_holder
                and self._admin_lock_holder != client
                and now - self._admin_lock_ts < 60
            ):
                return Response.error(
                    f"locked by {self._admin_lock_holder}", 409
                )
            self._admin_lock_holder = client
            self._admin_lock_ts = now
            return Response.json({"holder": client})

    def _handle_unlock(self, req: Request) -> Response:
        client = req.json().get("client", "unknown")
        with self._lock:
            if self._admin_lock_holder == client:
                self._admin_lock_holder = None
            return Response.json({"holder": None})
