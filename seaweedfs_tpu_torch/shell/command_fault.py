"""fault.inject / fault.list / fault.clear — drive the fault registry.

Behavioral model: chaos tooling over the /admin/fault endpoint every
server exposes (seaweedfs_tpu/fault/): arm a named fault point with a
kind, probability, fire count, and deterministic seed; list armed
specs with their fire counts; clear them. Injected faults show up as
tagged spans (trace.dump) and in seaweedfs_fault_injected_total.

The port's copy of ``seaweedfs_tpu/shell/command_fault.py``.
"""

from __future__ import annotations

import argparse
import json

from ..util import http
from .commands import CommandEnv, command


def _servers(env: CommandEnv, opt: str) -> list[str]:
    return [s for s in opt.split(",") if s] or [env.master_url]


@command(
    "fault.inject",
    "fault.inject -point name [-server url[,url...]] [-kind "
    "error|latency|conn_drop|partition] [-status n] [-probability p] "
    "[-count n] [-delay s] [-peer substr] [-seed n] "
    "# arm a fault point",
)
def cmd_fault_inject(env: CommandEnv, args: list[str], out) -> None:
    """Arm one fault spec on the given servers (default: the master).
    A fixed -seed makes probabilistic faults replay deterministically."""
    p = argparse.ArgumentParser(prog="fault.inject")
    p.add_argument("-server", default="")
    p.add_argument("-point", required=True)
    p.add_argument("-kind", default="error")
    p.add_argument("-status", type=int, default=503)
    p.add_argument("-probability", type=float, default=1.0)
    p.add_argument("-count", type=int, default=None)
    p.add_argument("-delay", type=float, default=0.0)
    p.add_argument("-peer", default="")
    p.add_argument("-seed", type=int, default=0)
    opts = p.parse_args(args)
    spec = {
        "action": "inject",
        "point": opts.point,
        "kind": opts.kind,
        "status": opts.status,
        "probability": opts.probability,
        "count": opts.count,
        "delay": opts.delay,
        "peer": opts.peer,
        "seed": opts.seed,
    }
    for srv in _servers(env, opts.server):
        try:
            got = http.post_json(f"{srv}/admin/fault", spec)
            out.write(
                f"{srv}: armed {json.dumps(got['injected'])}\n"
            )
        except http.HttpError as e:
            out.write(f"# {srv}: {e}\n")


@command(
    "fault.list",
    "fault.list [-server url[,url...]] # armed faults + fire counts",
)
def cmd_fault_list(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="fault.list")
    p.add_argument("-server", default="")
    opts = p.parse_args(args)
    for srv in _servers(env, opts.server):
        try:
            got = http.get_json(f"{srv}/admin/fault")
        except http.HttpError as e:
            out.write(f"# {srv}: {e}\n")
            continue
        faults = got.get("faults", [])
        if not faults:
            out.write(f"{srv}: no faults armed\n")
        for f in faults:
            out.write(f"{srv}: {json.dumps(f)}\n")


@command(
    "fault.clear",
    "fault.clear [-server url[,url...]] [-point name] "
    "# disarm faults (all points when -point is omitted)",
)
def cmd_fault_clear(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="fault.clear")
    p.add_argument("-server", default="")
    p.add_argument("-point", default=None)
    opts = p.parse_args(args)
    body = {"action": "clear", "point": opts.point}
    for srv in _servers(env, opts.server):
        try:
            http.post_json(f"{srv}/admin/fault", body)
            out.write(f"{srv}: cleared\n")
        except http.HttpError as e:
            out.write(f"# {srv}: {e}\n")
