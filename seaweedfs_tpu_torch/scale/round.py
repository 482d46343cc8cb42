"""SCALE rounds: one churn scenario, measured and regression-gated.

A round builds a ScaleHarness from a TopologySpec, drives mixed
zipfian load (command/benchmark.py) while the churn engine kills
servers, then waits for the cluster to self-heal (scale/converge.py)
with zero operator input. The record lands in ``SCALE_rNN.json`` in
the BENCH/LOAD trajectory shape and gates through util/benchgate.py:
time-to-converge regressing 20% fails the check, same as a GB/s drop.

The port's copy of ``seaweedfs_tpu/scale/round.py``. :func:`run_scale_round`
takes ``device=`` (``None`` is the card and raises without one, before
anything starts; ``"cpu"`` the kernels' plain versions). A lock witness
the round installs for its contention section is removed again when
the round ends, putting back whatever lock factories were there before.
A spec with filer shards (``fN``) runs its shard tier and records its
``detail.filer`` section; the ``s3``, ``fuse`` and ``broker`` personas
run through the port's S3 gateway, ``WFS`` and message broker.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..command import benchmark as bench_mod
from ..maintenance import MaintenancePolicy
from ..telemetry import recorder as flight
from ..util import benchgate
from ..util import http
from ..util import lockwitness
from ..util import retry as retry_mod
from .churn import ChurnEngine, ChurnProfile
from .converge import wait_for_convergence
from .harness import ScaleHarness
from .spec import TopologySpec


def scale_policy(
    pulse_seconds: float, warm: bool = False
) -> MaintenancePolicy:
    """An accelerated maintenance plane for scale rounds: detector
    rounds every ~2 pulses, no cooldown gaps, and only the task types
    convergence depends on (replica fixes, EC shard rebuilds, vacuum)
    — balance moves volumes for evenness, which mid-churn is motion
    the convergence verdict should not wait on. The warm profile adds
    ec_encode: the round seeds full+quiet warm volumes and the plane
    must find and encode them on its own while churn runs."""
    task_types = ("fix_replication", "ec_rebuild", "vacuum")
    if warm:
        task_types = task_types + ("ec_encode",)
    return MaintenancePolicy(
        enabled=True,
        interval=max(2 * pulse_seconds, 0.5),
        workers=4,
        task_types=task_types,
        quiet_seconds=0.0,
        cooldown_seconds=0.0,
        per_node_concurrency=2,
        per_type_concurrency=4,
    )


def seed_warm_volumes(
    harness: ScaleHarness,
    count: int,
    seed: int = 1,
    out=print,
) -> dict:
    """Grow `count` single-replica volumes in the ``warm`` collection
    and stuff each past the EC full threshold with direct
    volume-server writes (no assigns — the master's layout would
    rotate writes away from a filling volume), then leave them quiet.
    That is exactly the shape the maintenance detector's ec_encode
    predicate hunts: full, quiet, not yet erasure-coded.

    The plane stays paused while the volumes fill (and is resumed after,
    unless the caller had paused it): with no quiet window, a detector
    round that sees a volume cross the full threshold mid-seed would
    mark it read-only under the writer. The reference's seeding races
    the same way; at its 1 MiB limit the last few writes outrun a
    heartbeat, at 64 MiB they do not."""
    master = harness.master.url
    limit = harness.master.topo.volume_size_limit
    plane = harness.master.maintenance
    was_paused = plane.paused
    plane.pause()
    try:
        return _seed(harness, master, limit, count, seed, out)
    finally:
        if not was_paused:
            plane.resume()


def _seed(harness, master: str, limit: int, count: int, seed: int,
          out) -> dict:
    """seed_warm_volumes' writes, the plane paused."""
    import random

    from .. import operation
    from ..maintenance import ops

    grown = http.get_json(
        f"{master}/vol/grow?collection=warm&count={count}"
        "&replication=000",
        retry=retry_mod.ADMIN,
    )
    targets: list[tuple[int, str]] = []
    for dn in ops.data_nodes(master):
        for v in dn.get("volumes", ()):
            if v.get("collection") == "warm":
                targets.append((int(v["id"]), dn["url"]))
    targets.sort()
    rnd = random.Random(seed)
    # past the detector's full threshold (policy full_percent, 95% by
    # default) with margin; local writes ignore the master-side limit
    target_bytes = int(limit * 1.05)
    chunk = 128 * 1024
    key = 1
    total = 0
    for vid, url in targets:
        written = 0
        while written < target_bytes:
            data = rnd.randbytes(chunk)
            operation.upload(url, f"{vid},{key:x}00000001", data)
            key += 1
            written += len(data)
        total += written
    out(
        f"  warm tier: seeded {len(targets)} volumes "
        f"({grown.get('count', 0)} grown, {total >> 20} MiB) past "
        f"the EC threshold"
    )
    return {
        "volumes": [vid for vid, _url in targets],
        "bytes": total,
    }


def _sample_master_requests(master_urls) -> int:
    """requests.total summed over the master tier's own telemetry
    rows (fan-in proxy: heartbeat POSTs + lookups + assigns land
    here). Accepts one url or the full tier — a leader round samples
    every live master, so the count survives the original leader
    dying between the two samples (the delta is clamped at the call
    site: the dead master's requests leave the sum)."""
    if isinstance(master_urls, str):
        master_urls = [master_urls]
    total = 0
    for url in master_urls:
        try:
            view = http.get_json(
                f"{url}/cluster/telemetry", retry=retry_mod.LOOKUP
            )
        except (http.HttpError, OSError):
            continue
        for s in view.get("servers", ()):
            if s.get("component") == "master":
                total += int(
                    (s.get("requests") or {}).get("total", 0)
                )
                break  # one row per master's own view — no double count
    return total


def _failover_detail(
    engine: ChurnEngine,
    conv: dict,
    t_conv0: float,
    pulse_seconds: float,
    n_masters: int,
) -> dict:
    """The leader round's failover numbers, from the churn engine's
    kill/election stamps plus the benchmark's per-op trace.

    * ``failover_converge_s`` — leader kill → the cluster stably
      healthy ON THE NEW LEADER (the first poll of the convergence
      streak); the round's headline converge_seconds only starts once
      load ends, this one starts at the kill.
    * ``midfailover_failure_rate`` — failed WRITES over the writes
      attempted in the election window [kill, elected + 2 pulses]
      (the tail covers clients still discovering the winner). Writes
      are the ops failover owns: every write needs a master assign,
      so a client stuck on the dead master fails ~all of them, while
      a leader-aware client fails none. Reads/deletes of fids whose
      only replica rode a churn-killed volume server fail identically
      whoever leads the master tier, so counting them would gate
      volume-churn luck, not failover. 0/0 counts as 0.0 — an
      election faster than the op rate is a success, not a division
      error."""
    kill = engine.leader_kill_mono
    elected = engine.leader_elected_mono
    out: dict = {
        "masters": n_masters,
        "new_leader": engine.new_leader_idx,
    }
    for a in engine.actions:
        if a["action"] == "kill_leader":
            out["killed_master"] = a["servers"][0]
            break
    if kill is None:
        # the kill never landed (no leader resolvable): the round is
        # not a failover measurement — record why, gate nothing
        out["kill_landed"] = False
        return out
    out["kill_landed"] = True
    if elected is not None:
        out["election_s"] = round(elected - kill, 3)
    if conv["converged"]:
        healthy_at = t_conv0 + conv["seconds"]
        out["failover_converge_s"] = round(healthy_at - kill, 3)
    win_end = (
        elected if elected is not None
        # no observed winner: fall back to the election-timeout
        # ceiling so the window is still bounded
        else kill + 10 * pulse_seconds
    ) + 2 * pulse_seconds
    trace = bench_mod.LAST_OP_TRACE or []
    in_window = [
        t for t in trace
        if t[1] == "write" and kill <= t[0] <= win_end
    ]
    failed = sum(1 for t in in_window if not t[2])
    out["window_op"] = "write"
    out["ops_in_window"] = len(in_window)
    out["failed_in_window"] = failed
    out["midfailover_failure_rate"] = round(
        failed / len(in_window), 6
    ) if in_window else 0.0
    return out


def run_scale_round(
    spec: TopologySpec | str = TopologySpec(),
    seed: int = 1,
    pulse_seconds: float = 0.5,
    churn_kind: str = "flat",
    churn_interval: float | None = None,
    kill_fraction: float = 0.1,
    load_seconds: float = 6.0,
    load_concurrency: int = 8,
    load_mix: str = "write:50,read:40,delete:10",
    personas: str = "",
    replication: str = "000",
    assign_batch: int = 16,
    converge_timeout: float = 120.0,
    record_hz: float = 2.0,
    warm_volumes: int | None = None,
    volume_size_limit_mb: int | None = None,
    masters: int | None = None,
    device: str | torch.device | None = None,
    json_path: str = "",
    check_path: str = "",
    check_threshold: float | None = None,
    out=print,
) -> dict:
    """One full scale scenario; returns the round record (and writes /
    gates it when asked). The scenario: spawn the fleet, run mixed
    zipfian load, kill `kill_fraction` of the servers while it runs
    (they STAY dead — convergence must come from repair, not revival),
    stop churn, and time the self-heal.

    The ``warm`` churn kind is the combined round: before load starts
    it seeds full+quiet warm-tier volumes (at a small volume limit so
    seeding is cheap), the maintenance plane EC-encodes them on its
    own while flat-style kills and zipfian load run, and the record
    gains the fleet-aggregate EC throughput headline
    (``detail.fleet_ec_GBps``, gated higher-is-better).

    The ``leader`` churn kind is the failover round: the spec grows a
    raft master tier (forced to >= 3), the engine kills the raft
    LEADER on its first tick mid-ingest (then flat-style volume
    kills), every client path re-resolves onto the winner, and the
    record gains two gated metrics — ``detail.failover_converge_s``
    (kill → stably healthy on the new leader) and
    ``detail.midfailover_failure_rate`` (failed ops inside the
    election window, noise-floored in benchgate)."""
    device = resolve_device(device)
    if isinstance(spec, str):
        spec = TopologySpec.parse(spec)
    if masters is not None and masters != spec.masters:
        spec = dataclasses.replace(spec, masters=masters)
    leader = churn_kind == "leader"
    if leader and spec.masters < 3:
        # a leader kill needs survivors that still form a quorum
        spec = dataclasses.replace(spec, masters=3)
    n = spec.total_servers
    warm = churn_kind == "warm"
    if warm and volume_size_limit_mb is None:
        volume_size_limit_mb = 1
    if warm_volumes is None:
        warm_volumes = max(3, n // 12) if warm else 0
    kills_wanted = max(1, int(n * kill_fraction))
    churn_iv = (
        churn_interval
        if churn_interval is not None
        else max(load_seconds / (kills_wanted + 1), 0.2)
    )
    out(
        f"scale round: {spec} ({n} servers"
        + (f", {spec.masters} masters" if spec.masters > 1 else "")
        + f"), seed={seed}, churn={churn_kind}/{churn_iv:.2f}s, "
        f"kill {kills_wanted} ({kill_fraction:.0%})"
    )
    # contention profiling rides the lock witness: install it before
    # the fleet creates its locks so every site is wrapped, and remove
    # it when the round ends (SEAWEEDFS_LOCKWITNESS=0 leaves the
    # contention section empty)
    witness = lockwitness.current()
    installed_witness = False
    if record_hz > 0 and (witness is None or not witness.installed):
        if os.environ.get("SEAWEEDFS_LOCKWITNESS", "1") != "0":
            lockwitness.install()
            installed_witness = True
    harness_kwargs: dict = {}
    if volume_size_limit_mb is not None:
        harness_kwargs["volume_size_limit_mb"] = volume_size_limit_mb
    try:
        harness = ScaleHarness(
            spec,
            pulse_seconds=pulse_seconds,
            maintenance_policy=scale_policy(pulse_seconds, warm=warm),
            device=device,
            **harness_kwargs,
        )
    except BaseException:
        if installed_witness:
            lockwitness.uninstall()
        raise
    warm_seeded: dict = {}
    try:
        harness.wait_for_nodes(n, timeout=max(30.0, n * 0.5))
        if warm and warm_volumes:
            warm_seeded = seed_warm_volumes(
                harness, warm_volumes, seed=seed, out=out
            )
            # the detector reads volume sizes off the master topology,
            # which heartbeats refresh — give them one pulse to land
            time.sleep(2 * pulse_seconds)
        t_up = time.monotonic()
        master = harness.master.url
        tier = harness.master_urls()
        multi = harness.n_masters > 1
        # flight recorder: frames from here to convergence become the
        # round's timeline; the contention section is the witness
        # delta from this baseline (the witness is process-global, so
        # earlier rounds' waits must not leak in)
        contention_base = flight.contention_baseline()
        rec_t0 = time.monotonic()
        if record_hz > 0:
            flight.RECORDER.start(hz=record_hz)
        profile = ChurnProfile(
            kind=churn_kind, interval=churn_iv,
            max_kills=kills_wanted,
        )
        engine = ChurnEngine(
            harness, profile, seed=seed,
            min_live=n - kills_wanted,
        )
        load_result: dict = {}
        # the spec's filer tier: persona front doors (S3 / FUSE /
        # broker) ride the shard ring instead of spawning their own
        # single filer, so persona traffic exercises shard routing
        # and lands in the per-shard metadata ledger
        filer_ring = harness.filer_ring()

        def run_load() -> None:
            bench_mod.run_benchmark(
                master,
                concurrency=load_concurrency,
                collection="scale",
                mix=load_mix,
                sizes="512-4096",
                zipf_s=1.1,
                duration=load_seconds,
                seed=seed,
                replication=replication,
                assign_batch=assign_batch,
                filer_url=filer_ring or "",
                # multi-master: assigns/lookups ride the leader-aware
                # ring, and leader rounds trace per-op completion so
                # the election window's failure rate is computable
                master_peers=tier if multi else None,
                op_trace=leader,
                # persona mode: churn + maintenance + multi-protocol
                # traffic coexist; the front doors spawn in-proc
                # against this round's master and per-protocol rates
                # land in the round's detail.protocols
                personas=personas,
                out=lambda *_: None,
            )
            # the benchmark pushed its summary to the master; keep the
            # local copy for the round record
            load_result.update(bench_mod.LAST_RESULT or {})

        req0 = _sample_master_requests(tier)
        loader = threading.Thread(
            target=run_load, name="scale-load", daemon=True
        )
        loader.start()
        with engine:
            loader.join(timeout=load_seconds + 60)
        # the engine only ticks while the load runs; if scheduling
        # under-delivered, top up so the round always inflicts the
        # advertised node loss (still seeded: same rng stream)
        if engine.kills < kills_wanted:
            engine.kill_random(kills_wanted - engine.kills)
        churn_seconds = time.monotonic() - t_up
        req1 = _sample_master_requests(tier)
        # per-shard metadata golden signals, sampled NOW (the ledger's
        # ops_s is a rolling window — convergence can take long enough
        # to decay it). Process-global, so it survives leader churn.
        filer_section = None
        if spec.filers > 0:
            from ..telemetry.snapshot import FILER_SHARDS

            filer_section = FILER_SHARDS.section()
        if loader.is_alive():
            raise RuntimeError("load generator hung past its window")

        # convergence: poll the same view the shell renders (the poll
        # latencies it records are the aggregator read latencies);
        # multi-master polling re-resolves the leader each poll — a
        # checker pinned to the dead ex-leader would never go green
        t_conv0 = time.monotonic()
        conv = wait_for_convergence(
            tier if multi else master,
            live_urls=harness.live_urls,
            expect_volume_servers=lambda: len(
                harness.live_indices()
            ),
            timeout=converge_timeout,
            poll_interval=max(pulse_seconds, 0.25),
        )
        failover = _failover_detail(
            engine, conv, t_conv0, pulse_seconds, spec.masters,
        ) if leader else None
        maint = harness.master.maintenance.telemetry()
        # fleet EC observatory: the aggregator's rollup over the live
        # servers' telemetry, sampled while the fleet is still up, and
        # the master's shard map as ground truth for what got encoded
        # (robust to encoders that died after finishing)
        ec_rollup = harness.master.telemetry.view().get("ec") or {}
        encoded_vids = sorted(
            vid for (_col, vid) in harness.master.topo.ec_shard_map
        )
        warm_encoded = sorted(
            vid for (col, vid) in harness.master.topo.ec_shard_map
            if col == "warm"
        )
        actions = list(engine.actions)
        killed = sorted(harness.down)
    finally:
        if record_hz > 0:
            flight.RECORDER.stop()
        harness.stop()
        if installed_witness:
            lockwitness.uninstall()
    timeline = flight.build_timeline(
        flight.RECORDER.frames(since=rec_t0),
        hz=record_hz,
        costs=flight.RECORDER.sample_cost_ms(),
    ) if record_hz > 0 else None
    contention = flight.contention_section(baseline=contention_base)
    flight.sync_lock_metrics()

    lat = np.asarray(conv["poll_ms"], dtype=np.float64)
    phases = (load_result.get("detail") or {}).get("phases") or {}
    load_fail = sum(p.get("failures", 0) for p in phases.values())
    load_ops = sum(p.get("ops", 0) for p in phases.values())
    result = {
        "metric": "scale_converge_seconds",
        "value": conv["seconds"],
        "unit": "s",
        "detail": {
            "spec": str(spec),
            "servers": n,
            "seed": seed,
            "converged": conv["converged"],
            "converge_seconds": conv["seconds"],
            "converge_polls": conv["polls"],
            "last_reasons": conv["last_reasons"],
            "churn": {
                "kind": churn_kind,
                "interval": round(churn_iv, 3),
                "killed": killed,
                "actions": actions,
            },
            "load_ops_per_second": float(
                load_result.get("value") or 0.0
            ),
            "load_failure_rate": round(
                load_fail / load_ops, 6
            ) if load_ops else 0.0,
            "load_detail": load_result.get("detail") or {},
            "heartbeat_fanin_hz": round(
                (n - len(killed)) / pulse_seconds, 1
            ),
            # clamped: a leader killed between the samples takes its
            # request count out of the second sum
            "master_requests_per_second": round(
                max(0, req1 - req0) / churn_seconds, 1
            ) if churn_seconds > 0 else 0.0,
            "telemetry_poll_p50_ms": round(
                float(np.percentile(lat, 50)), 3
            ) if lat.size else 0.0,
            "telemetry_poll_p99_ms": round(
                float(np.percentile(lat, 99)), 3
            ) if lat.size else 0.0,
            "maintenance": maint,
            "contention": contention,
        },
    }
    if failover is not None:
        result["detail"]["failover"] = failover
        # the two gated metrics surface as detail scalars (that is
        # where benchgate.flatten_scale reads round metrics from)
        if "failover_converge_s" in failover:
            result["detail"]["failover_converge_s"] = (
                failover["failover_converge_s"]
            )
        if "midfailover_failure_rate" in failover:
            result["detail"]["midfailover_failure_rate"] = (
                failover["midfailover_failure_rate"]
            )
    if timeline is not None:
        result["detail"]["timeline"] = timeline
    if filer_section:
        # the metadata-plane section benchgate._flatten_filer gates:
        # tier-aggregate ops/s downward, per-shard p99/error upward
        result["detail"]["filer"] = {
            "shard_count": spec.filers,
            "meta_ops_s": round(sum(
                sec.get("ops_s", 0.0)
                for sec in filer_section.values()
            ), 3),
            "shards": filer_section,
        }
    protocols = (load_result.get("detail") or {}).get("protocols")
    if protocols:
        # persona rounds promote the per-protocol section to a
        # first-class detail key: benchgate's shared flattener gates
        # the same protocols.* names a LOAD round records
        result["detail"]["protocols"] = protocols
        result["detail"]["personas"] = (
            (load_result.get("detail") or {}).get("personas") or ""
        )
    if ec_rollup.get("encodes_total"):
        # the gated headline: fleet-aggregate encode bandwidth —
        # source bytes over PhaseTimer busy time, summed across the
        # fleet (deterministic, unlike the live windowed rate whose
        # value depends on when inside the window you sample it)
        busy = float(ec_rollup.get("busy_seconds_total") or 0.0)
        nbytes = float(ec_rollup.get("bytes_total") or 0.0)
        result["detail"]["fleet_ec_GBps"] = round(
            nbytes / busy / 1e9, 6
        ) if busy > 0 else 0.0
        result["detail"]["ec_encoded_volumes"] = len(encoded_vids)
        result["detail"]["ec_encoded_warm_volumes"] = len(warm_encoded)
        result["detail"]["fleet_ec"] = {
            "window_GBps": ec_rollup.get("fleet_GBps", 0.0),
            "bytes_total": int(nbytes),
            "busy_seconds_total": round(busy, 6),
            "volumes_total": ec_rollup.get("volumes_total", 0),
            "encodes_total": ec_rollup.get("encodes_total", 0),
            "seeded": warm_seeded,
        }
    verdict = "converged" if conv["converged"] else "DID NOT CONVERGE"
    out(
        f"scale round: {verdict} in {conv['seconds']:.1f}s "
        f"({conv['polls']} polls) after {len(killed)} kills; "
        f"load {result['detail']['load_ops_per_second']:.1f} ops/s, "
        f"telemetry p99 "
        f"{result['detail']['telemetry_poll_p99_ms']:.1f} ms"
    )
    if not conv["converged"]:
        out("  stuck on: " + "; ".join(conv["last_reasons"]))
    if failover is not None and failover.get("kill_landed"):
        out(
            f"  failover: killed master "
            f"{failover.get('killed_master')} -> leader "
            f"{failover.get('new_leader')} in "
            f"{failover.get('election_s', float('nan')):.2f}s; "
            f"kill->healthy "
            f"{failover.get('failover_converge_s', float('nan')):.2f}s"
            f"; election-window write-failure rate "
            f"{failover.get('midfailover_failure_rate', 0.0):.4f} "
            f"({failover.get('failed_in_window', 0)}/"
            f"{failover.get('ops_in_window', 0)} ops)"
        )
    if protocols:
        out("  protocols: " + ", ".join(
            f"{name} {sec.get('ops_s', 0.0):.1f} ops/s "
            f"(p99 {1e3 * sec.get('p99_s', 0.0):.0f} ms, "
            f"err {sec.get('error_rate', 0.0):.3f})"
            for name, sec in sorted(protocols.items())
        ))
    if filer_section:
        fsec = result["detail"]["filer"]
        out(
            f"  filer: {fsec['meta_ops_s']:.1f} meta ops/s over "
            f"{fsec['shard_count']} shards (" + ", ".join(
                f"{name} {sec.get('ops_s', 0.0):.1f}"
                for name, sec in sorted(filer_section.items())
            ) + ")"
        )
    if "fleet_ec_GBps" in result["detail"]:
        out(
            f"  fleet EC: {result['detail']['fleet_ec_GBps']:.3f} GB/s"
            f" over {result['detail']['fleet_ec']['encodes_total']} "
            f"encodes ({result['detail']['ec_encoded_volumes']} "
            f"volumes now erasure-coded, "
            f"{result['detail']['ec_encoded_warm_volumes']} warm)"
        )
    top_sites = contention.get("top") or []
    if top_sites:
        r0 = top_sites[0]
        out(
            f"  top contended lock: {r0['site']} "
            f"(total wait {r0['total_wait_s']:.3f}s, "
            f"p99 {1e3 * r0['p99_wait_s']:.1f} ms)"
        )
    if json_path:
        benchgate.stamp_provenance(
            result, os.path.dirname(json_path) or ".", "SCALE"
        )
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1)
        out(f"wrote {json_path}")
    if check_path:
        result["check_rc"] = run_check(
            result, check_path, check_threshold, out=out
        )
    return result


def run_check(
    result: dict,
    baseline_path: str,
    threshold: float | None = None,
    out=print,
) -> int:
    """Gate a SCALE result against a stored round: 0 = within
    threshold, 1 = regression (converge time / poll latency / failure
    rate rise, ops/s drop), 2 = unusable baseline."""
    thr = (
        threshold if threshold is not None
        else benchgate.CHECK_THRESHOLD
    )
    try:
        baseline = benchgate.load_round(baseline_path)
    except (OSError, ValueError) as e:
        out(f"--check: cannot load baseline {baseline_path}: {e}")
        return 2
    # kind-registry dispatch: a SCALE result normally gates against a
    # SCALE baseline, but the registry keeps the flattener choice in
    # one table shared with bench.py --check and weed trends
    flatten, lower_is_better = benchgate.gate_kind(result, baseline)
    msgs = benchgate.check_regression(
        result, baseline, thr,
        flatten=flatten,
        lower_is_better=lower_is_better,
    )
    if msgs:
        out(
            f"SCALE REGRESSION vs {baseline_path} "
            f"(threshold {thr:.0%}):"
        )
        for m in msgs:
            out("  " + m)
        return 1
    compared = benchgate.compared_metrics(
        result, baseline, flatten=flatten
    )
    out(
        f"scale check vs {baseline_path}: OK "
        f"({len(compared)} metrics within {thr:.0%})"
    )
    return 0
