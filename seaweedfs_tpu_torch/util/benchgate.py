"""Shared perf-regression gate over recorded benchmark rounds.

Two CLIs record trajectory rounds and must never let a number silently
regress: ``bench.py`` (codec/wired GB/s, BENCH_rNN.json) and
``weed benchmark`` (request-path ops/s and latency, LOAD_rNN.json).
Both gates are the same operation — flatten a round's numeric metrics
by name, compare only the metrics present in BOTH runs, fail past a
relative threshold — so the flatten/compare logic lives here once.

The one asymmetry between the two shapes: every BENCH metric is a
throughput (a DROP is a regression), while a LOAD round mixes
throughputs (ops/s — drop regresses) with latencies and failure rates
(an INCREASE regresses). ``check_regression`` takes a
``lower_is_better`` predicate over metric names so each flattener
declares its own directions.

The port's copy of ``seaweedfs_tpu/util/benchgate.py``: pure functions
over round dicts, equal to the reference's on every recorded round.
"""

from __future__ import annotations

import json
from typing import Callable

# default: fail on a >=20% adverse move in any shared metric (the
# round-2 840x codec regression shipped because nothing compared runs)
CHECK_THRESHOLD = 0.2


def load_round(path: str) -> dict:
    """A stored round: either the raw JSON line a bench CLI prints or
    a driver round file (BENCH_rNN.json / LOAD_rNN.json) whose
    "parsed" key holds it."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc


def flatten_bench(result: dict) -> dict[str, float]:
    """The comparable metrics of one codec bench run (bench.py),
    flattened by name: the headline GB/s, per-kernel
    encode/rebuild/dev8, every numeric sweep entry (RS shapes, batched
    volumes), and the wired end-to-end path as FIRST-CLASS names —
    ``detail.wired_GBps`` / ``detail.wired_codec_fraction`` are emitted
    from the explicit detail fields (falling back to the sweep entries
    older rounds recorded) so the wired number always gates under a
    stable name even if the sweep layout changes."""
    out: dict[str, float] = {}
    if isinstance(result.get("value"), (int, float)):
        out["value"] = float(result["value"])
    detail = result.get("detail") or {}
    for key in ("encode_GBps", "rebuild_GBps", "dev8_GBps",
                "wired_GBps", "wired_codec_fraction"):
        v = detail.get(key)
        if isinstance(v, (int, float)):
            out[f"detail.{key}"] = float(v)
    sweep = detail.get("sweep_GBps") or {}
    for key, v in sweep.items():
        if isinstance(v, (int, float)):
            out[f"sweep.{key}"] = float(v)
    # older rounds only carried the wired numbers inside the sweep:
    # promote them to the stable first-class names
    if "detail.wired_GBps" not in out and isinstance(
        sweep.get("wired_batch_4vol"), (int, float)
    ):
        out["detail.wired_GBps"] = float(sweep["wired_batch_4vol"])
    if "detail.wired_codec_fraction" not in out and isinstance(
        sweep.get("wired_batch_codec_fraction"), (int, float)
    ):
        out["detail.wired_codec_fraction"] = float(
            sweep["wired_batch_codec_fraction"]
        )
    return out


# The only metrics comparable ACROSS bench kinds: the wired
# volume→shards GB/s is recorded by both the full codec round and the
# standalone --wired round under the same stable name, and the
# 8-device scaling efficiency gates wherever both rounds measured it —
# the explicit ROADMAP gates that keep the wired path from regressing
# to the r02 class and the multichip flatness from silently worsening.
_CROSS_KIND_GATED = ("detail.wired_GBps", "scaling_efficiency_8")

# LOAD metric names where an INCREASE is the regression: phase
# latencies (ms), per-protocol persona latencies (seconds), and
# failure/error rates. Throughput names ALSO end in "_s"
# (`protocols.*.ops_s`) — the `_is_ops_rate` guard in both direction
# predicates runs before suffix matching so every ops rate keeps
# gating downward.
_LOAD_LOWER_IS_BETTER = ("_ms", "_s", "failure_rate", "error_rate")

# persona mixes drive fault-prone front doors (broker proxying,
# multipart completion against a busy filer) where a few percent of
# ops legitimately fail between runs; relative comparison below this
# floor is timing noise — same rationale and value as SCALE's churn
# floor. Applied to phase failure rates and protocol error rates.
LOAD_FAILURE_RATE_FLOOR = 0.05

# per-protocol persona p50/p99 on an in-proc fleet sit in the
# single-digit-to-tens-of-ms band where GIL scheduling luck dominates
# (the same measured band behind SCALE_POLL_P99_FLOOR_MS); latencies
# under 50 ms gate as equal, a real front-door melt (100 ms+) still
# trips the relative gate
LOAD_PROTOCOL_P99_FLOOR_S = 0.05

# the same damping for per-phase latencies: p50/p99/max of a small
# in-proc round are one-or-few worst samples (a max_ms of 13 vs 27 ms
# between back-to-back identical runs is pure scheduling luck, seen
# flaking the self-gate even at a 90% threshold); sub-floor values
# gate as equal while a real request-path melt (100 ms+) still trips
LOAD_PHASE_LATENCY_FLOOR_MS = 50.0

# per-SHARD meta-op p99 during a churn round is a handful of
# fsync-bound worst samples on a contended host (measured 0.15s vs
# 0.49s between back-to-back identical rounds); the tier's health
# gates on the aggregate filer.meta_ops_s, so the per-shard p99 only
# needs to catch an egregious melt — sub-floor values gate as equal
FILER_SHARD_P99_FLOOR_S = 0.5

# a shard serving a trickle (hash partitioning is lumpy: one bucket
# namespace = one shard, so a round's cold shard may see single-digit
# ops) has an ops/s made of sample noise — floor it so only a shard
# doing real traffic gates on throughput; a cold shard's health still
# shows in its error_rate and in the tier aggregate
FILER_SHARD_OPS_FLOOR_S = 5.0


def _is_ops_rate(name: str) -> bool:
    return name.endswith(("ops_s", "ops_per_second"))


def load_lower_is_better(name: str) -> bool:
    if _is_ops_rate(name):
        return False
    return name.endswith(_LOAD_LOWER_IS_BETTER)


def _flatten_protocols(detail: dict, out: dict[str, float],
                       errors_only: bool = False) -> None:
    """Flatten a round's per-protocol persona section
    (``detail.protocols.{native,s3,fuse,broker}.*``) into the gateable
    names LOAD and SCALE rounds share: ``ops_s`` gates downward like
    every throughput; ``p50_s``/``p99_s`` (floored at
    LOAD_PROTOCOL_P99_FLOOR_S) and ``error_rate`` (floored at
    LOAD_FAILURE_RATE_FLOOR) gate upward. ``errors_only`` keeps just
    the error rates — churn rounds record the rest as context."""
    keys = (
        ("error_rate",) if errors_only
        else ("ops_s", "p50_s", "p99_s", "error_rate")
    )
    for proto, sec in (detail.get("protocols") or {}).items():
        if not isinstance(sec, dict):
            continue
        for key in keys:
            v = sec.get(key)
            if not isinstance(v, (int, float)):
                continue
            v = float(v)
            if key in ("p50_s", "p99_s"):
                v = max(v, LOAD_PROTOCOL_P99_FLOOR_S)
            elif key == "error_rate":
                v = max(v, LOAD_FAILURE_RATE_FLOOR)
            out[f"protocols.{proto}.{key}"] = v


def _flatten_filer(detail: dict, out: dict[str, float]) -> None:
    """Flatten a round's sharded-filer section (``detail.filer``) into
    gateable names: the tier-aggregate ``filer.meta_ops_s`` gates
    downward (caught by ``_is_ops_rate``), and each bounded shard label
    contributes ``ops_s`` plus ``p99_s`` (floored at
    FILER_SHARD_P99_FLOOR_S) and ``error_rate`` (floored at
    LOAD_FAILURE_RATE_FLOOR). ``shard_count`` and ``shard_speedup`` are
    recorded context, not gated metrics (the speedup depends on host
    core count, so gating it would flake across machines)."""
    filer = detail.get("filer") or {}
    if not isinstance(filer, dict):
        return
    v = filer.get("meta_ops_s")
    if isinstance(v, (int, float)):
        out["filer.meta_ops_s"] = float(v)
    for shard, sec in (filer.get("shards") or {}).items():
        if not isinstance(sec, dict):
            continue
        for key in ("ops_s", "p99_s", "error_rate"):
            v = sec.get(key)
            if not isinstance(v, (int, float)):
                continue
            v = float(v)
            if key == "p99_s":
                v = max(v, FILER_SHARD_P99_FLOOR_S)
            elif key == "error_rate":
                v = max(v, LOAD_FAILURE_RATE_FLOOR)
            elif key == "ops_s":
                v = max(v, FILER_SHARD_OPS_FLOOR_S)
            out[f"filer.{shard}.{key}"] = v


def flatten_load(result: dict) -> dict[str, float]:
    """The comparable metrics of one load-generator run
    (``weed benchmark``): overall ops/s plus, per phase, ops/s and the
    p50/p99/max latencies and failure rate (noise-floored), plus the
    per-protocol persona section when the round recorded one."""
    out: dict[str, float] = {}
    if isinstance(result.get("value"), (int, float)):
        out["value"] = float(result["value"])
    detail = result.get("detail") or {}
    for phase, stats in (detail.get("phases") or {}).items():
        if not isinstance(stats, dict):
            continue
        for key in ("ops_per_second", "p50_ms", "p99_ms", "max_ms",
                    "failure_rate"):
            v = stats.get(key)
            if isinstance(v, (int, float)):
                v = float(v)
                if key == "failure_rate":
                    v = max(v, LOAD_FAILURE_RATE_FLOOR)
                elif key in ("p50_ms", "p99_ms", "max_ms"):
                    v = max(v, LOAD_PHASE_LATENCY_FLOOR_MS)
                out[f"phase.{phase}.{key}"] = v
    _flatten_protocols(detail, out)
    _flatten_filer(detail, out)
    return out


# SCALE metric names where an INCREASE is the regression: convergence
# time, poll latencies, load failure rate, lock wait, and the repair
# backlog peak all regress upward; the load throughput regresses
# downward like every other ops/s number
_SCALE_LOWER_IS_BETTER = (
    "_seconds", "_ms", "failure_rate", "_wait_s",
    "peak_repair_backlog", "peak_fds", "peak_threads",
    # leader-round failover headline (kill → stably healthy on the
    # new leader) — no shared suffix, so named exactly
    "failover_converge_s",
    # per-protocol persona names (observability arc): seconds-unit
    # latencies and error rates regress upward; `ops_s` is caught by
    # the _is_ops_rate guard before these suffixes apply
    "_s", "error_rate",
)

# a round that kills 10% of the fleet mid-write inherently fails a few
# percent of ops (in-flight requests to the victims); relative
# comparison below this floor is churn-timing noise, so rates under it
# gate as equal — a real degradation (0.02 -> 0.2) still trips hard
SCALE_FAILURE_RATE_FLOOR = 0.05

# same damping for the flight-recorder gates: scheduling-noise lock
# waits and single-digit repair-backlog peaks are luck between runs;
# values below the floor gate as equal, a real melt still trips hard.
# The lock-wait floor sits above the measured healthy band for an
# in-proc 100-server fleet on a contended CPU host (p99 acquisition
# waits of 0.03-0.52s across green runs — pure GIL scheduling): the
# gate exists to catch systemic contention melt, which is
# multi-second, not sub-second wobble.
SCALE_LOCK_WAIT_FLOOR = 0.75
SCALE_REPAIR_BACKLOG_FLOOR = 16.0

# telemetry-poll p99 across healthy identical-spec rounds ranges
# 22-40 ms on this box (a p99 over ~60 polls is one worst sample —
# pure scheduling luck); relative comparison inside that band is
# noise, while a real telemetry melt (the uncached-view regression
# measured p99 65 ms and up) still clears the floor and trips
SCALE_POLL_P99_FLOOR_MS = 50.0

# resource-peak gates (the reswitness arc): the fd/thread peaks a
# round's flight-recorder timeline records regress UPWARD — a leaky
# fan-out or an unshut pool shows as a higher peak at the same spec.
# The floors absorb per-run scheduler/allocator noise: a 100-server
# round legitimately sits in the low hundreds of fds and tens of
# threads, and single-digit wobble there is not a leak; a real one
# (every request leaking a socket) blows through the floor and trips
SCALE_FD_PEAK_FLOOR = 256.0
SCALE_THREAD_PEAK_FLOOR = 64.0

# fleet EC throughput (the warm-round headline): an aggregate over
# however many encodes the maintenance plane happened to schedule
# during the round, so small-absolute-value wobble between runs is
# scheduling luck, not a codec regression — on a contended CPU host
# the whole band (measured 0.001-0.005 at the 100-server spec) sits
# under this floor and gates as equal. On an accelerator the headline
# runs well above the floor, where a real collapse (the encoder
# falling off the vectorized path drops it orders of magnitude)
# still trips the relative gate. Unlike latencies this one regresses
# DOWNWARD (it is a throughput).
SCALE_FLEET_EC_GBPS_FLOOR = 0.01

# leader-round failover gates: the election timeout is drawn uniform
# from [5, 10] pulses (server/raft.py _timeout_range), so at the scale
# pulse of 0.5s two green runs legitimately differ by seconds in
# kill-to-healthy time — below the floor gates as equal, a systemic
# melt (heartbeats never re-homing, convergence off the dead master)
# lands tens of seconds up and still trips. The mid-failover rate
# counts only the WRITE path (the one that needs a master assign, so
# the one failover owns — scale/round.py _failover_detail): green
# leader-aware clients measure ~0, so the floor only has to absorb
# redraw-exhaustion luck (three pooled draws all landing churn-killed
# servers), while a client pinned to the dead master fails ~every
# write in the window and trips from any floor.
SCALE_FAILOVER_CONVERGE_FLOOR_S = 8.0
SCALE_MIDFAILOVER_RATE_FLOOR = 0.05


def scale_lower_is_better(name: str) -> bool:
    if _is_ops_rate(name):
        return False
    return name.endswith(_SCALE_LOWER_IS_BETTER) or name == "value"


def flatten_scale(result: dict) -> dict[str, float]:
    """The comparable metrics of one scale round (scale/round.py):
    time-to-converge (the headline value), telemetry poll latencies,
    and the load generator's throughput/failure numbers recorded while
    churn ran. Counts that scale with the scenario (kills, polls) are
    context, not gated metrics."""
    out: dict[str, float] = {}
    if isinstance(result.get("value"), (int, float)):
        out["value"] = float(result["value"])
    detail = result.get("detail") or {}
    for key in ("converge_seconds", "load_ops_per_second",
                "load_failure_rate", "telemetry_poll_p50_ms",
                "telemetry_poll_p99_ms"):
        v = detail.get(key)
        if isinstance(v, (int, float)):
            out[f"detail.{key}"] = float(v)
    # warm-round headline (fleet observatory arc): aggregate EC encode
    # GB/s across the fleet while churn+load ran; higher is better,
    # noise-floored because the absolute value depends on how many
    # encodes the maintenance plane scheduled inside the window
    v = detail.get("fleet_ec_GBps")
    if isinstance(v, (int, float)):
        out["detail.fleet_ec_GBps"] = max(
            float(v), SCALE_FLEET_EC_GBPS_FLOOR
        )
    fr = out.get("detail.load_failure_rate")
    if fr is not None:
        out["detail.load_failure_rate"] = max(
            fr, SCALE_FAILURE_RATE_FLOOR
        )
    # leader-round failover metrics (failover arc): kill-to-healthy
    # gates upward with an election-timeout noise floor; the election
    # window's failure rate noise-floors like the load rate
    v = detail.get("failover_converge_s")
    if isinstance(v, (int, float)):
        out["detail.failover_converge_s"] = max(
            float(v), SCALE_FAILOVER_CONVERGE_FLOOR_S
        )
    v = detail.get("midfailover_failure_rate")
    if isinstance(v, (int, float)):
        out["detail.midfailover_failure_rate"] = max(
            float(v), SCALE_MIDFAILOVER_RATE_FLOOR
        )
    p99 = out.get("detail.telemetry_poll_p99_ms")
    if p99 is not None:
        out["detail.telemetry_poll_p99_ms"] = max(
            p99, SCALE_POLL_P99_FLOOR_MS
        )
    # flight-recorder sections (PR 11+ rounds): the worst top-site
    # lock wait and the repair-backlog peak over the round's timeline
    # gate upward like latencies; older rounds without the sections
    # simply never compare on them
    contention = detail.get("contention") or {}
    v = contention.get("p99_wait_s")
    if isinstance(v, (int, float)):
        out["detail.contention.p99_wait_s"] = max(
            float(v), SCALE_LOCK_WAIT_FLOOR
        )
    peaks = (detail.get("timeline") or {}).get("peaks") or {}
    v = peaks.get("repair_backlog")
    if isinstance(v, (int, float)):
        out["detail.timeline.peak_repair_backlog"] = max(
            float(v), SCALE_REPAIR_BACKLOG_FLOOR
        )
    # resource peaks (reswitness arc rounds): open fds and live
    # threads gate upward with noise floors; rounds recorded before
    # the fds probe existed simply never compare on them
    for probe, key, floor in (
        ("fds", "peak_fds", SCALE_FD_PEAK_FLOOR),
        ("threads", "peak_threads", SCALE_THREAD_PEAK_FLOOR),
    ):
        v = peaks.get(probe)
        if isinstance(v, (int, float)):
            out[f"detail.timeline.{key}"] = max(float(v), floor)
    # persona traffic run inside a scale round (weed scale -personas)
    # records the same per-protocol section a LOAD round does, but a
    # churn round's per-protocol split is election-timing luck over
    # tiny samples (the s3 persona completes tens of ops while the
    # fleet churns — its p99 is ONE worst multipart PUT, measured
    # swinging 5s vs 9.6s between identical back-to-back rounds), so
    # only the error rates gate here; throughput and latency per
    # protocol gate in the controlled LOAD stage, and the round's
    # aggregate gates via load_ops_per_second above
    _flatten_protocols(detail, out, errors_only=True)
    _flatten_filer(detail, out)
    return out


# MULTICHIP floors: CPU-forced 8-host-device sweeps run steps in the
# tens of milliseconds where scheduler jitter dominates, and the
# recorded truth is that efficiency-at-8 is ~0.12 (flat scaling) —
# relative moves below these floors are noise, values under them gate
# as equal while a real collapse (0.12 -> 0.01) still trips
MULTICHIP_SEC_PER_STEP_FLOOR = 0.05
MULTICHIP_EFFICIENCY_FLOOR = 0.02

# Absolute floor on the staged-lane dispatch path's ceiling-aware
# scaling_efficiency_8 — the ROADMAP's ">=70%-at-8-chips" target,
# reachable since PR 14 (per-chip staging lanes + compiled dispatch
# cache; MULTICHIP_r08 measured 0.80-0.99 across runs of the 1-core
# host backend, vs 0.33-class for an r06-style flat round where t(8)
# ~ 3*t(1)). Relative --check comparison alone can ratchet a few
# percent per round forever; this pins the post-fix level so the
# rebuild-per-call class of regression can never ship. Applied only
# to rounds whose ``detail.dispatch == "staged-lanes"`` —
# legacy-dispatch and pre-PR-14 rounds keep flattening and gating
# relative-only.
MULTICHIP_EFFICIENCY_8_MIN = 0.7


def multichip_lower_is_better(name: str) -> bool:
    # sec/step regresses upward; scaling_efficiency_N regresses
    # downward (higher is better) like every throughput
    return name.startswith("sec_per_step")


def _multichip_sec_per_step(result: dict) -> dict:
    """The sec/step-per-device-count table of a multichip round, from
    either shape: first-class rounds carry ``detail.sec_per_step``;
    legacy r01–r05 rounds only carry the driver-grepped
    ``MULTICHIP_SCALING {...}`` line inside ``tail``."""
    detail = result.get("detail") or {}
    sps = detail.get("sec_per_step")
    if isinstance(sps, dict) and sps:
        return sps
    tail = result.get("tail")
    if isinstance(tail, str) and "MULTICHIP_SCALING" in tail:
        line = tail.split("MULTICHIP_SCALING", 1)[1].strip()
        line = line.splitlines()[0] if line else ""
        try:
            doc = json.loads(line)
        except ValueError:
            return {}
        sps = doc.get("sec_per_step")
        if isinstance(sps, dict):
            return sps
    return {}


def is_multichip_round(result: dict) -> bool:
    return bool(_multichip_sec_per_step(result))


def flatten_multichip(result: dict) -> dict[str, float]:
    """The comparable metrics of one multichip scaling round:
    ``sec_per_step.N`` per device count plus the derived
    ``scaling_efficiency_N`` = t(1)/(min(N, P)*t(N)) — recomputed here
    from the sec/step table so legacy tail-only rounds (which never
    stored an efficiency) flatten to the same names and the trajectory
    isn't orphaned. P is the recorded ``detail.host_parallelism``
    (PR 14+ rounds; the achievable-speedup ceiling of a forced host
    backend — see telemetry.devices.scaling_efficiency); rounds
    without it flatten with the classic N denominator exactly as
    before. Decomposition fractions are diagnostic attribution, not
    gated metrics. The headline ``value`` duplicates
    ``scaling_efficiency_8`` in first-class rounds, so it is not
    emitted separately (it would double-gate the same number)."""
    out: dict[str, float] = {}
    sps: dict[int, float] = {}
    for n, v in _multichip_sec_per_step(result).items():
        try:
            n = int(n)
        except (TypeError, ValueError):
            continue
        if isinstance(v, (int, float)) and v > 0:
            sps[n] = float(v)
    for n, v in sorted(sps.items()):
        out[f"sec_per_step.{n}"] = max(v, MULTICHIP_SEC_PER_STEP_FLOOR)
    par = (result.get("detail") or {}).get("host_parallelism")
    cap = int(par) if isinstance(par, (int, float)) and par >= 1 else None
    t1 = sps.get(1)
    if t1:
        for n, v in sorted(sps.items()):
            if n > 1:
                denom = min(n, cap) if cap else n
                out[f"scaling_efficiency_{n}"] = max(
                    t1 / (denom * v), MULTICHIP_EFFICIENCY_FLOOR
                )
    return out


def multichip_floor_violations(result: dict) -> list[str]:
    """Messages for a staged-lane multichip round whose headline
    efficiency fell under the absolute MULTICHIP_EFFICIENCY_8_MIN
    floor; empty for clean rounds AND for any round not recorded with
    ``detail.dispatch == "staged-lanes"`` (legacy-dispatch recordings
    and the pre-PR-14 trajectory gate relative-only)."""
    detail = (result or {}).get("detail") or {}
    if detail.get("dispatch") != "staged-lanes":
        return []
    eff = flatten_multichip(result).get("scaling_efficiency_8")
    if eff is None or eff >= MULTICHIP_EFFICIENCY_8_MIN:
        return []
    return [
        f"scaling_efficiency_8: {eff:.4f} under the staged-lanes "
        f"floor {MULTICHIP_EFFICIENCY_8_MIN} "
        "(benchgate.MULTICHIP_EFFICIENCY_8_MIN)"
    ]


def check_regression(
    current: dict,
    baseline: dict,
    threshold: float = CHECK_THRESHOLD,
    flatten: Callable[[dict], dict[str, float]] = flatten_bench,
    lower_is_better: Callable[[str], bool] | None = None,
) -> list[str]:
    """One message per metric that moved adversely >= threshold vs
    baseline.

    Only metrics present in BOTH runs are compared — a metric the
    current platform can't produce (e.g. a CPU-only rerun of a TPU
    round) never gates, and new metrics have no baseline to regress
    from. ``lower_is_better(name)`` flips the adverse direction for
    latency-style metrics; zero-valued latency baselines never gate
    (any nonzero current value would be an infinite relative rise).

    Rounds of DIFFERENT metric kinds (a ``bench.py --wired`` round
    checked against a stored full codec round) gate only the
    geometry-normalized wired throughput: the bare headline ``value``
    (0.04 wired GB/s vs 309 kernel GB/s) and diagnostic ratios like
    the codec fraction are kind-specific and would fire nonsense
    regressions. Same-kind rounds compare everything, fractions
    included."""
    msgs: list[str] = []
    cur = flatten(current)
    base = flatten(baseline)
    m_cur, m_base = current.get("metric"), baseline.get("metric")
    if m_cur and m_base and m_cur != m_base:
        cur = {k: v for k, v in cur.items() if k in _CROSS_KIND_GATED}
    for name, b in sorted(base.items()):
        c = cur.get(name)
        if c is None or b <= 0:
            continue
        if lower_is_better is not None and lower_is_better(name):
            move = (c - b) / b
            verb = "rise"
        else:
            move = (b - c) / b
            verb = "drop"
        if move >= threshold:
            msgs.append(
                f"{name}: {b:g} -> {c:g} "
                f"({100 * move:.1f}% {verb} >= {100 * threshold:.0f}%)"
            )
    return msgs


def compared_metrics(
    current: dict,
    baseline: dict,
    flatten: Callable[[dict], dict[str, float]] = flatten_bench,
) -> list[str]:
    """The metric names a check actually gated on (present in both,
    after the cross-kind filter check_regression applies)."""
    names = set(flatten(current)) & set(flatten(baseline))
    m_cur, m_base = current.get("metric"), baseline.get("metric")
    if m_cur and m_base and m_cur != m_base:
        names &= set(_CROSS_KIND_GATED)
    return sorted(names)


# ---- round-kind registry ------------------------------------------------
# Every consumer of a recorded round (bench.py --check, weed scale
# -check, weed benchmark -check, weed trends) used to hand-pick its
# flattener; the registry is the single table mapping a round's SHAPE
# to (kind, flatten, lower_is_better). Sniffers run in order — the
# multichip sniffer first because legacy multichip rounds are
# driver-shaped like BENCH files and only the tail betrays them; the
# bench entry is the catch-all.


def _is_scale_round(result: dict) -> bool:
    if result.get("metric") == "scale_converge_seconds":
        return True
    detail = result.get("detail") or {}
    return "converge_seconds" in detail


def _is_load_round(result: dict) -> bool:
    return result.get("metric") == "load_ops_per_second"


ROUND_KINDS: tuple[
    tuple[str, Callable[[dict], bool],
          Callable[[dict], dict[str, float]],
          Callable[[str], bool] | None], ...
] = (
    ("multichip", is_multichip_round, flatten_multichip,
     multichip_lower_is_better),
    ("scale", _is_scale_round, flatten_scale, scale_lower_is_better),
    ("load", _is_load_round, flatten_load, load_lower_is_better),
    ("bench", lambda _r: True, flatten_bench, None),
)


def round_kind(result: dict) -> str:
    """The registry kind of one recorded round dict."""
    for kind, sniff, _flatten, _lib in ROUND_KINDS:
        if sniff(result or {}):
            return kind
    return "bench"


def kind_entry(kind: str) -> tuple[
    Callable[[dict], dict[str, float]], Callable[[str], bool] | None
]:
    """(flatten, lower_is_better) for a registry kind name."""
    for name, _sniff, flatten, lib in ROUND_KINDS:
        if name == kind:
            return flatten, lib
    raise KeyError(f"unknown round kind {kind!r}")


def flatten_round(result: dict) -> dict[str, float]:
    """Flatten a round of ANY kind through its registry flattener."""
    flatten, _lib = kind_entry(round_kind(result))
    return flatten(result)


def gate_kind(current: dict, baseline: dict) -> tuple[
    Callable[[dict], dict[str, float]], Callable[[str], bool] | None
]:
    """(flatten, lower_is_better) for gating ``current`` against
    ``baseline``: if EITHER side is a multichip round the pair gates
    on the multichip names (a first-class round checked against a
    legacy tail-only baseline must still compare); otherwise the
    current round's own kind decides."""
    if is_multichip_round(baseline) or is_multichip_round(current):
        return kind_entry("multichip")
    return kind_entry(round_kind(current))


# ---- provenance ---------------------------------------------------------

_ROUND_FILE_RE = r"^(BENCH|LOAD|SCALE|MULTICHIP)_r(\d+)\.json$"


def round_files(dir_path: str = ".", prefix: str = "") -> list[str]:
    """Recorded round files in ``dir_path`` (optionally one kind's
    ``prefix``), sorted by filename."""
    import os
    import re

    pat = re.compile(_ROUND_FILE_RE)
    names = []
    try:
        entries = os.listdir(dir_path or ".")
    except OSError:
        return []
    for name in entries:
        m = pat.match(name)
        if m and (not prefix or m.group(1) == prefix):
            names.append(name)
    return sorted(names)


def stamp_provenance(
    result: dict, dir_path: str = ".", prefix: str = "BENCH"
) -> dict:
    """Stamp ``recorded_seq`` (one past the newest existing round of
    this kind in ``dir_path``) and the optional ``SEAWEEDFS_ROUND_PR``
    tag into ``result`` in place, so `weed trends` orders rounds by
    when they were recorded rather than filename-lexicographically.
    Existing rounds without a stamp count by their filename number."""
    import os
    import re

    newest = 0
    for name in round_files(dir_path, prefix):
        m = re.match(_ROUND_FILE_RE, name)
        seq = int(m.group(2))
        try:
            doc = load_round(os.path.join(dir_path or ".", name))
        except (OSError, ValueError):
            doc = {}
        stored = doc.get("recorded_seq")
        if isinstance(stored, int) and stored > seq:
            seq = stored
        newest = max(newest, seq)
    result["recorded_seq"] = newest + 1
    pr = os.environ.get("SEAWEEDFS_ROUND_PR", "")
    if pr:
        result["pr"] = pr
    return result
