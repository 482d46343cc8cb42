"""trace.dump — fetch and render distributed request traces.

Behavioral model: Dapper's trace-tree view over the per-server
`/debug/traces` rings (tracing/): spans from one or more servers are
merged (in one process the ring is shared; across processes each server
contributes its own spans), filtered to one trace, and rendered as an
indented tree by tracing/render.py.

The port's copy of ``seaweedfs_tpu/shell/command_trace.py``
(``trace.dump``, ``trace.slow``): the same output text.
"""

from __future__ import annotations

import argparse

from ..tracing import render_tree
from ..util import http
from .commands import CommandEnv, command


@command(
    "trace.dump",
    "trace.dump [-server url[,url...]] [-traceId id] [-limit n] "
    "# render a request's span tree",
)
def cmd_trace_dump(env: CommandEnv, args: list[str], out) -> None:
    """Merge /debug/traces from the given servers (default: the
    master) and render one trace — the given -traceId, or the most
    recently finished one — as an indented span tree."""
    p = argparse.ArgumentParser(prog="trace.dump")
    p.add_argument(
        "-server", default="",
        help="comma-separated server urls (default: the master)",
    )
    p.add_argument("-traceId", default="")
    p.add_argument(
        "-limit", type=int, default=0,
        help="only consider the last N spans per server",
    )
    opts = p.parse_args(args)
    servers = [s for s in opts.server.split(",") if s] or [
        env.master_url
    ]
    qs = []
    if opts.traceId:
        qs.append(f"traceId={opts.traceId}")
    if opts.limit:
        qs.append(f"limit={opts.limit}")
    suffix = ("?" + "&".join(qs)) if qs else ""
    spans: dict[str, dict] = {}
    for srv in servers:
        try:
            got = http.get_json(f"{srv}/debug/traces{suffix}")
        except http.HttpError as e:
            out.write(f"# {srv}: {e}\n")
            continue
        for s in got.get("spans", []):
            spans.setdefault(s["span_id"], s)
    if not spans:
        out.write("no spans recorded\n")
        return
    trace_id = opts.traceId
    if not trace_id:
        newest = max(
            spans.values(), key=lambda s: s["start"] + s["duration"]
        )
        trace_id = newest["trace_id"]
    tree = [s for s in spans.values() if s["trace_id"] == trace_id]
    out.write(render_tree(tree))


@command(
    "trace.slow",
    "trace.slow [-server url[,url...]] [-limit n] "
    "# slowest requests with their trace ids",
)
def cmd_trace_slow(env: CommandEnv, args: list[str], out) -> None:
    """Merge each server's /debug/slow ledger (telemetry/slow.py) and
    list the slowest requests — duration, op, status, peer, fault
    tags, and the trace id to feed straight into
    `trace.dump -traceId ...`."""
    p = argparse.ArgumentParser(prog="trace.slow")
    p.add_argument(
        "-server", default="",
        help="comma-separated server urls (default: the master)",
    )
    p.add_argument("-limit", type=int, default=10)
    opts = p.parse_args(args)
    servers = [s for s in opts.server.split(",") if s] or [
        env.master_url
    ]
    entries: dict[str, dict] = {}
    for srv in servers:
        try:
            got = http.get_json(f"{srv}/debug/slow")
        except http.HttpError as e:
            out.write(f"# {srv}: {e}\n")
            continue
        for e in got.get("slow", []):
            entries.setdefault(e.get("span_id", ""), e)
    if not entries:
        out.write("no slow requests recorded\n")
        return
    ranked = sorted(
        entries.values(),
        key=lambda e: e.get("duration", 0.0),
        reverse=True,
    )[: opts.limit]
    out.write(
        f"{'duration':>10} {'op':28} {'st':>3} {'peer':21} "
        f"trace id\n"
    )
    for e in ranked:
        op = f"{e.get('component', '?')}.{e.get('op', '?')}"
        faults = e.get("faults") or {}
        tag = (
            " [" + ",".join(
                f"{v}" for k, v in sorted(faults.items())
                if k == "fault.point"
            ) + "]"
            if faults
            else ""
        )
        out.write(
            f"{e.get('duration', 0.0) * 1e3:>8.1f}ms "
            f"{op:28} {e.get('status', 0):>3} "
            f"{e.get('peer', '') or '-':21} "
            f"{e.get('trace_id', '')}{tag}\n"
        )
