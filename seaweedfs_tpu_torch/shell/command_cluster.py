"""cluster.health / cluster.stats — render the aggregated telemetry.

Behavioral model: the operator surface the reference spreads across
its stats handlers and master UI (weed/stats/metrics.go:19-123,
weed/server/master_ui), folded into two shell commands over the
master's `/cluster/telemetry` aggregate (telemetry/aggregator.py):
`cluster.health` answers "is the cluster healthy and is the SLO
burning", `cluster.stats` adds the per-server table detail and a
hot-volume heatmap from the topology.

The port's copy of ``seaweedfs_tpu/shell/command_cluster.py``: the same
commands (``cluster.health``, ``cluster.stats``, ``cluster.profile``,
``cluster.devices``, ``cluster.timeline``, ``cluster.contention``) and
the same output text, over the port's servers.
"""

from __future__ import annotations

import argparse
import time

from ..util import http
from .commands import CommandEnv, command

_RAMP = " ▁▂▃▄▅▆▇█"


def _fmt_seconds(v: float | None) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    return f"{v * 1e3:.1f}ms"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _server_table(view: dict, out) -> None:
    out.write(
        f"{'role':7} {'server':21} {'up':>8} {'req':>7} {'err':>5} "
        f"{'err%':>6} {'p50':>8} {'p99':>8} {'rss':>9} {'thr':>4} "
        f"state\n"
    )
    for s in view.get("servers", []):
        req = s.get("requests") or {}
        proc = s.get("process") or {}
        state = ",".join(s.get("degraded") or []) or "ok"
        out.write(
            f"{s.get('component', '?'):7} "
            f"{s.get('url', '') or '-':21} "
            f"{s.get('uptime_seconds', 0):>7.1f}s "
            f"{req.get('total', 0):>7} "
            f"{req.get('errors', 0):>5} "
            f"{100 * req.get('error_rate', 0.0):>5.1f}% "
            f"{_fmt_seconds(req.get('p50_seconds')):>8} "
            f"{_fmt_seconds(req.get('p99_seconds')):>8} "
            f"{_fmt_bytes(proc.get('rss_bytes', 0)):>9} "
            f"{proc.get('threads', 0):>4} "
            f"{state}\n"
        )


def _maintenance_line(view: dict, out) -> None:
    """One line of maintenance-plane state from the master's snapshot
    (queue depth, outcome totals, last detector round, backlog flag)."""
    maint = None
    for s in view.get("servers", []):
        if s.get("component") == "master" and s.get("maintenance"):
            maint = s["maintenance"]
            break
    if not maint:
        return
    if not maint.get("enabled"):
        out.write("maintenance: disabled\n")
        return
    age = (
        # last_round is the MASTER's wall epoch; the shell is another
        # process, so wall-clock arithmetic is the only shared clock
        time.time() - maint["last_round"]  # weedcheck: ignore[wall-clock-duration]
        if maint.get("last_round") else None
    )
    backlog = maint.get("backlog_seconds", 0.0)
    flags = ""
    if maint.get("paused"):
        flags += "  PAUSED"
    if (
        maint.get("interval", 0) > 0
        and backlog > 3 * maint["interval"]
    ):
        flags += "  BACKLOG"
    out.write(
        f"maintenance: queued={maint.get('queued', 0)} "
        f"running={maint.get('running', 0)} "
        f"completed={maint.get('completed', 0)} "
        f"failed={maint.get('failed', 0)} "
        f"skipped={maint.get('skipped', 0)} "
        f"backlog={backlog:.1f}s "
        f"last-round={age:.1f}s ago"
        f"{flags}\n"
        if age is not None else
        f"maintenance: queued={maint.get('queued', 0)} "
        f"running={maint.get('running', 0)} (no round yet){flags}\n"
    )


def _benchmark_line(view: dict, out) -> None:
    """One line of load-generator state from the master's snapshot:
    the last `weed benchmark` round's ops/s + worst p99, kept in the
    same pane as SLO burn so capacity and health read together."""
    bench = None
    for s in view.get("servers", []):
        if s.get("component") == "master" and s.get("benchmark"):
            bench = s["benchmark"]
            break
    if not bench:
        return
    src = bench.get("source") or "?"
    fails = bench.get("failures", 0)
    out.write(
        f"load: {bench.get('ops_per_second', 0.0):.1f} ops/s, "
        f"p99 {bench.get('p99_ms', 0.0):.1f}ms, "
        f"{fails} failed ({src})\n"
    )


def _protocols_line(view: dict, out) -> None:
    """One line per front-door protocol from the aggregator's LIVE
    rollup (persona traffic: native / s3 / fuse / broker ops/s, p99
    and error rate); falls back to the last pushed benchmark round's
    per-protocol block (tagged with its source) when the load ran in
    another process; silent while no persona load ever ran."""
    protocols = view.get("protocols") or {}
    src = ""
    if not protocols:
        for s in view.get("servers", []):
            if s.get("component") == "master" and s.get("benchmark"):
                protocols = s["benchmark"].get("protocols") or {}
                src = s["benchmark"].get("source") or "?"
                break
    if not protocols:
        return
    parts = []
    for name, sec in sorted(protocols.items()):
        if not isinstance(sec, dict):
            continue
        parts.append(
            f"{name} {sec.get('ops_s', 0.0):.1f} ops/s "
            f"(p99 {1e3 * sec.get('p99_s', 0.0):.0f}ms, "
            f"err {sec.get('error_rate', 0.0):.3f})"
        )
    if parts:
        tag = f" ({src})" if src else ""
        out.write("protocols: " + " · ".join(parts) + tag + "\n")


def _filer_line(view: dict, out) -> None:
    """One line per filer shard from the aggregator's LIVE rollup
    (filer/sharding metadata golden signals: per-shard ops/s, p99,
    error rate); silent while no filer traffic ever ran — an
    unsharded filer reports under the single `shard0` label."""
    shards = view.get("filer") or {}
    parts = []
    for name, sec in sorted(shards.items()):
        if not isinstance(sec, dict):
            continue
        parts.append(
            f"{name} {sec.get('ops_s', 0.0):.1f} ops/s "
            f"(p99 {1e3 * sec.get('p99_s', 0.0):.0f}ms, "
            f"err {sec.get('error_rate', 0.0):.3f})"
        )
    if parts:
        out.write("filer: " + " · ".join(parts) + "\n")


def _fleet_ec_line(view: dict, out) -> None:
    """One line of fleet EC throughput from the aggregator's rollup:
    the windowed GB/s headline (interval-delta based — dead servers
    age out) plus lifetime totals; silent while nothing has encoded."""
    ec = view.get("ec") or {}
    if not ec.get("encodes_total"):
        return
    out.write(
        f"fleet EC: {ec.get('fleet_GBps', 0.0):.3f} GB/s windowed "
        f"({ec.get('reporting', 0)} reporting, "
        f"{ec.get('window_seconds', 0):.0f}s window) · "
        f"{_fmt_bytes(ec.get('bytes_total', 0))} encoded over "
        f"{ec.get('encodes_total', 0)} encodes / "
        f"{ec.get('volumes_total', 0)} volumes\n"
    )


def _contention_line(view: dict, out,
                     p99_threshold: float = 0.010) -> None:
    """Flag melting locks: the master's snapshot carries the top-3
    contended sites; any with p99 wait past the threshold (10 ms)
    prints, with the full table one `cluster.contention` away."""
    top = None
    for s in view.get("servers", []):
        if s.get("component") == "master" and s.get("contention"):
            top = s["contention"]
            break
    if not top:
        return
    hot = [r for r in top if r.get("p99_wait_s", 0.0) > p99_threshold]
    if not hot:
        return
    for r in hot:
        out.write(
            f"lock contention: {r.get('site', '?')} p99 wait "
            f"{1e3 * r.get('p99_wait_s', 0.0):.1f}ms "
            f"({r.get('blocked', 0)} blocked, "
            f"{r.get('total_wait_s', 0.0):.3f}s total)\n"
        )
    out.write("hint: `cluster.contention` shows the full table\n")


def _devices_line(view: dict, out,
                  threshold: float = 0.20) -> None:
    """Flag device imbalance: the master's snapshot carries the
    dispatch ledger's summary; a (max−min) busy spread past the
    threshold fraction of the mean busy prints, with the per-chip
    table one `cluster.devices` away."""
    dev = None
    for s in view.get("servers", []):
        if s.get("component") == "master" and s.get("devices"):
            dev = s["devices"]
            break
    if not dev:
        return
    frac = dev.get("imbalance_frac", 0.0)
    if frac <= threshold:
        return
    out.write(
        f"devices: busy imbalance {100 * frac:.0f}% of mean across "
        f"{dev.get('devices', 0)} chips "
        f"(busy {dev.get('busy_min_s', 0.0):.2f}–"
        f"{dev.get('busy_max_s', 0.0):.2f}s over "
        f"{dev.get('dispatches', 0)} dispatches)\n"
    )
    out.write("hint: `cluster.devices` shows the per-chip table\n")


def _fetch_view(env: CommandEnv, opts) -> dict:
    qs = []
    if getattr(opts, "errorRate", None) is not None:
        qs.append(f"sloErrorRate={opts.errorRate}")
    if getattr(opts, "p99", None) is not None:
        qs.append(f"sloP99={opts.p99}")
    suffix = ("?" + "&".join(qs)) if qs else ""
    return http.get_json(
        f"{opts.server or env.master_url}/cluster/telemetry{suffix}"
    )


@command(
    "cluster.health",
    "cluster.health [-server url] [-errorRate x] [-p99 s] "
    "# aggregated health + SLO burn",
)
def cmd_cluster_health(env: CommandEnv, args: list[str], out) -> None:
    """One screen answering "is the cluster healthy": overall verdict,
    SLO burn (error rate and p99 vs. the objectives — overridable per
    read), the per-server table with degradation markers, injected
    faults, and open circuit breakers. When p99 is burning, the next
    command is `trace.slow`."""
    p = argparse.ArgumentParser(prog="cluster.health")
    p.add_argument("-server", default="")
    p.add_argument("-errorRate", type=float, default=None)
    p.add_argument("-p99", type=float, default=None)
    opts = p.parse_args(args)
    view = _fetch_view(env, opts)
    slo = view["slo"]
    verdict = "OK" if view.get("healthy") else "DEGRADED"
    out.write(
        f"cluster: {verdict} · roles: "
        f"{','.join(view.get('components', [])) or 'none'}\n"
    )
    out.write(
        f"SLO error-rate {slo['error_rate']:.4f} / "
        f"{slo['error_rate_objective']:.4f} "
        f"(burn {slo['error_burn']:.2f}x)"
        f"{'  BURNING' if slo['error_burn'] > 1 else ''}\n"
    )
    out.write(
        f"SLO p99 {_fmt_seconds(slo['p99_seconds'])} / "
        f"{_fmt_seconds(slo['p99_seconds_objective'])} "
        f"(burn {slo['p99_burn']:.2f}x)"
        f"{'  BURNING' if slo['p99_burn'] > 1 else ''}\n"
    )
    _server_table(view, out)
    _maintenance_line(view, out)
    _benchmark_line(view, out)
    _protocols_line(view, out)
    _filer_line(view, out)
    _fleet_ec_line(view, out)
    _contention_line(view, out)
    _devices_line(view, out)
    faults = view.get("faults") or {}
    if faults:
        out.write(
            "faults injected: "
            + ", ".join(
                f"{k}={int(v)}" for k, v in sorted(faults.items())
            )
            + "\n"
        )
    if view.get("breakers_open"):
        out.write(f"circuit breakers open: {view['breakers_open']}\n")
    if slo["p99_burn"] > 1:
        out.write("hint: `trace.slow` lists the offending requests\n")


@command(
    "cluster.profile",
    "cluster.profile [-server url] [-seconds n] [-hz n] [-top n] "
    "[-raw] # sample a server's thread stacks (folded flamegraph "
    "input)",
)
def cmd_cluster_profile(env: CommandEnv, args: list[str], out) -> None:
    """Pull a sampling profile from one server's `/debug/profile`
    (default: the master) and print the hottest functions by self
    samples plus the heaviest whole stacks; `-raw` dumps the full
    folded-stack text for flamegraph.pl / speedscope."""
    p = argparse.ArgumentParser(prog="cluster.profile")
    p.add_argument("-server", default="")
    p.add_argument("-seconds", type=float, default=2.0)
    p.add_argument("-hz", type=int, default=100)
    p.add_argument("-top", type=int, default=10)
    p.add_argument("-raw", action="store_true")
    opts = p.parse_args(args)
    url = opts.server or env.master_url
    body = http.request(
        "GET",
        f"{url}/debug/profile?seconds={opts.seconds}&hz={opts.hz}",
        timeout=opts.seconds + 30,
    ).decode("utf-8", "replace")
    if opts.raw:
        out.write(body)
        return
    from ..telemetry import profile as profile_mod

    agg: dict[str, int] = {}
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        try:
            agg[stack] = int(count)
        except ValueError:
            continue
    total = sum(agg.values())
    out.write(
        f"profile of {url}: {total} samples over {opts.seconds:g}s\n"
    )
    if not total:
        out.write("no samples (idle server or window too short)\n")
        return
    out.write("hottest functions (self samples):\n")
    for frame, count in profile_mod.top_functions(agg, opts.top):
        out.write(
            f"  {count:6d} {100 * count / total:5.1f}%  {frame}\n"
        )
    out.write("heaviest stacks:\n")
    for stack, count in sorted(
        agg.items(), key=lambda kv: -kv[1]
    )[: max(1, opts.top // 2)]:
        frames = stack.split(";")
        tail = ";".join(frames[-4:]) if len(frames) > 4 else stack
        out.write(
            f"  {count:6d} {100 * count / total:5.1f}%  ...{tail}\n"
        )


@command(
    "cluster.devices",
    "cluster.devices [-server url] # per-chip dispatch ledger: "
    "busy/launch/transfer per device + host staging lanes",
)
def cmd_cluster_devices(env: CommandEnv, args: list[str], out) -> None:
    """Render one server's `/debug/devices` (default: the master):
    the per-chip dispatch ledger — compute-busy seconds, dispatch and
    launch-serialization counts, H2D/D2H bytes with link-estimated
    seconds — plus the host staging lanes and the busy-imbalance
    aggregate `cluster.health` alerts on."""
    p = argparse.ArgumentParser(prog="cluster.devices")
    p.add_argument("-server", default="")
    opts = p.parse_args(args)
    url = opts.server or env.master_url
    snap = http.get_json(f"{url}/debug/devices")
    rows = snap.get("devices") or []
    if not rows:
        out.write(f"{url}: no device dispatches recorded yet\n")
        return
    out.write(
        f"{'dev':>4} {'plat':>6} {'busy_s':>10} {'disp':>6} "
        f"{'launch_s':>9} {'h2d_MB':>9} {'d2h_MB':>9} "
        f"{'xfer_s_est':>10}\n"
    )
    for r in rows:
        xfer = r.get("h2d_s_est", 0.0) + r.get("d2h_s_est", 0.0)
        out.write(
            f"{r.get('device', '?'):>4} "
            f"{r.get('platform', '?'):>6} "
            f"{r.get('busy_s', 0.0):>10.3f} "
            f"{r.get('dispatches', 0):>6d} "
            f"{r.get('launch_s', 0.0):>9.4f} "
            f"{r.get('h2d_bytes', 0) / 1e6:>9.1f} "
            f"{r.get('d2h_bytes', 0) / 1e6:>9.1f} "
            f"{xfer:>10.4f}\n"
        )
    imb = snap.get("imbalance") or {}
    out.write(
        f"imbalance: spread {imb.get('spread_s', 0.0):.3f}s "
        f"({100 * imb.get('frac', 0.0):.1f}% of mean "
        f"{imb.get('mean_s', 0.0):.3f}s)\n"
    )
    totals = snap.get("totals") or {}
    out.write(
        f"host: stage {totals.get('stage_s', 0.0):.3f}s, launch "
        f"{totals.get('launch_s', 0.0):.3f}s over "
        f"{int(totals.get('dispatches', 0))} dispatches\n"
    )
    # staged vs residual: how much of mean device busy is explicitly
    # measured host-side (per-lane staging + launch enqueue) vs left
    # unattributed — the split the staging lanes exist to expose;
    # a residual-dominated line means waits are hiding in dispatch
    staged = totals.get("stage_s", 0.0) + totals.get("launch_s", 0.0)
    mean_busy = imb.get("mean_s", 0.0)
    residual = max(0.0, mean_busy - staged)
    denom = max(staged + residual, 1e-9)
    out.write(
        f"split: staged {staged:.3f}s "
        f"({100 * staged / denom:.1f}%) vs residual "
        f"{residual:.3f}s ({100 * residual / denom:.1f}%)\n"
    )
    lanes = snap.get("lanes") or []
    for lr in lanes:
        out.write(
            f"lane {lr.get('lane', '?'):>3}: busy "
            f"{lr.get('busy_s', 0.0):.3f}s, "
            f"{lr.get('chunks', 0)} chunks, "
            f"{lr.get('bytes', 0) / 1e6:.1f} MB staged\n"
        )


@command(
    "cluster.stats",
    "cluster.stats [-server url] [-top n] "
    "# per-server table + hot-volume heatmap",
)
def cmd_cluster_stats(env: CommandEnv, args: list[str], out) -> None:
    """The detail view: the per-server telemetry table plus a
    hot-volume heatmap (file count per volume, normalized across the
    cluster) and the N hottest volumes with their locations."""
    p = argparse.ArgumentParser(prog="cluster.stats")
    p.add_argument("-server", default="")
    p.add_argument("-top", type=int, default=5)
    opts = p.parse_args(args)
    view = _fetch_view(env, opts)
    _server_table(view, out)
    req = view.get("requests") or {}
    out.write(
        f"cluster requests: {req.get('total', 0)} total, "
        f"{req.get('errors', 0)} errors "
        f"(+{req.get('delta', 0)}/+{req.get('error_delta', 0)} "
        f"last interval)\n"
    )
    # hot-volume heatmap from the topology (file count per volume)
    volumes: list[tuple[int, str, int, int]] = []
    for dn in env.data_nodes():
        for v in dn.get("volumes", []):
            volumes.append(
                (v["id"], dn["url"], v["file_count"], v["size"])
            )
    if not volumes:
        out.write("no volumes\n")
        return
    hottest = max(fc for (_v, _u, fc, _s) in volumes) or 1
    out.write("hot volumes (files per volume, ramp vs hottest):\n")
    by_node: dict[str, list[tuple[int, int]]] = {}
    for vid, url, fc, _size in volumes:
        by_node.setdefault(url, []).append((vid, fc))
    for url in sorted(by_node):
        cells = ""
        for _vid, fc in sorted(by_node[url]):
            idx = round((len(_RAMP) - 1) * fc / hottest)
            cells += _RAMP[idx]
        out.write(f"  {url:21} |{cells}|\n")
    out.write(f"top {opts.top} by file count:\n")
    for vid, url, fc, size in sorted(
        volumes, key=lambda t: t[2], reverse=True
    )[: opts.top]:
        out.write(
            f"  volume {vid} @ {url}: {fc} files, {_fmt_bytes(size)}\n"
        )


def _sparkline(vals: list[float], cells: int = 48) -> str:
    """Max-downsampled ASCII ramp of a series, normalized to its own
    peak (spikes must survive both the downsample and the render)."""
    if not vals:
        return ""
    if len(vals) > cells:
        n = len(vals)
        vals = [
            max(vals[i * n // cells:max(i * n // cells + 1,
                                        (i + 1) * n // cells)])
            for i in range(cells)
        ]
    peak = max(vals)
    if peak <= 0:
        return _RAMP[0] * len(vals)
    return "".join(
        _RAMP[round((len(_RAMP) - 1) * max(v, 0.0) / peak)]
        for v in vals
    )


@command(
    "cluster.timeline",
    "cluster.timeline [-server url] [-seconds n] [-probe name] "
    "# flight-recorder sparklines (one per probe)",
)
def cmd_cluster_timeline(env: CommandEnv, args: list[str], out) -> None:
    """Render a server's flight-recorder frames (`/debug/timeline`)
    as one sparkline per probe — heartbeat fan-in, aggregator lock
    wait, repair backlog, RSS — each normalized to its own peak over
    the window. `-probe` filters by substring."""
    p = argparse.ArgumentParser(prog="cluster.timeline")
    p.add_argument("-server", default="")
    p.add_argument("-seconds", type=float, default=60.0)
    p.add_argument("-probe", default="")
    opts = p.parse_args(args)
    url = opts.server or env.master_url
    doc = http.get_json(
        f"{url}/debug/timeline?seconds={opts.seconds:g}"
    )
    frames = doc.get("recent") or []
    state = "recording" if doc.get("running") else "stopped"
    out.write(
        f"flight recorder @ {url}: {state} "
        f"(hz={doc.get('hz', 0):g}, {len(frames)} frames in last "
        f"{opts.seconds:g}s, ring {doc.get('frames', 0)}"
        f"/{doc.get('capacity', 0)})\n"
    )
    if not frames:
        out.write(
            "no frames (recorder idle — scale rounds start it, or "
            "attach via telemetry.recorder.RECORDER.start())\n"
        )
        return
    names = sorted(
        {k for f in frames for k in f if k != "t"}
    )
    if opts.probe:
        names = [n for n in names if opts.probe in n]
    span = frames[-1]["t"] - frames[0]["t"]
    out.write(f"window: {span:.1f}s, peak-normalized per probe\n")
    width = max((len(n) for n in names), default=0)
    for name in names:
        vals = [f[name] for f in frames if name in f]
        if not vals:
            continue
        out.write(
            f"  {name:<{width}} |{_sparkline(vals)}| "
            f"peak {max(vals):g} last {vals[-1]:g}\n"
        )
    cost = doc.get("sample_cost_ms") or {}
    if cost:
        out.write(
            f"sample cost: mean {cost.get('mean', 0):.2f}ms, "
            f"max {cost.get('max', 0):.2f}ms\n"
        )


@command(
    "cluster.contention",
    "cluster.contention [-server url] [-top n] [-stacks] "
    "# top-contended lock sites (wait p50/p99, hold totals)",
)
def cmd_cluster_contention(env: CommandEnv, args: list[str],
                           out) -> None:
    """The lock-contention profiler's table (`/debug/contention`):
    per creation site, how often acquires blocked, total/max/p50/p99
    wait, and hold totals; `-stacks` adds the first slow blocked
    thread's stack fingerprint per site."""
    p = argparse.ArgumentParser(prog="cluster.contention")
    p.add_argument("-server", default="")
    p.add_argument("-top", type=int, default=10)
    p.add_argument("-stacks", action="store_true")
    opts = p.parse_args(args)
    url = opts.server or env.master_url
    doc = http.get_json(f"{url}/debug/contention?top={opts.top}")
    rows = doc.get("top") or []
    if not doc.get("witness_installed"):
        out.write(
            "lock witness not installed in that process "
            "(SEAWEEDFS_LOCKWITNESS=0, or a plain server start); "
            "no contention data\n"
        )
        return
    if not rows:
        out.write("no contended lock sites observed\n")
        return
    out.write(
        f"top {len(rows)} contended lock sites @ {url}:\n"
    )
    out.write(
        f"{'site':42} {'kind':9} {'acq':>8} {'blocked':>8} "
        f"{'wait':>9} {'p50':>8} {'p99':>8} {'maxhold':>8}\n"
    )
    for r in rows:
        out.write(
            f"{r.get('site', '?'):42} {r.get('kind', '?'):9} "
            f"{r.get('acquires', 0):>8} {r.get('blocked', 0):>8} "
            f"{r.get('total_wait_s', 0.0):>8.3f}s "
            f"{_fmt_seconds(r.get('p50_wait_s', 0.0)):>8} "
            f"{_fmt_seconds(r.get('p99_wait_s', 0.0)):>8} "
            f"{_fmt_seconds(r.get('max_hold_s', 0.0)):>8}\n"
        )
        if opts.stacks and r.get("stack"):
            out.write(f"    blocked at: {r['stack']}\n")
