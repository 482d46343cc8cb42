"""maintenance.* — operate the autonomous maintenance plane.

Behavioral model: the operator surface the reference splits between
`master.toml` maintenance scripts and the `weed worker` admin UI,
folded onto the master's `GET/POST /cluster/maintenance` control
endpoint (maintenance/plane.py).

The port's copy of ``seaweedfs_tpu/shell/command_maintenance.py``.
"""

from __future__ import annotations

import argparse
import time

from ..util import http
from ..util import retry as retry_mod
from .commands import CommandEnv, command


def _fetch(env: CommandEnv, server: str = "") -> dict:
    return http.get_json(
        f"{server or env.master_url}/cluster/maintenance",
        retry=retry_mod.ADMIN,
    )


def _post(env: CommandEnv, payload: dict, server: str = "") -> dict:
    return http.post_json(
        f"{server or env.master_url}/cluster/maintenance", payload,
        retry=retry_mod.ADMIN,
    )


def _task_row(t: dict, now: float) -> str:
    age = now - t["created"]
    extra = f" batch={t['batch']}" if t.get("batch") else ""
    err = f" error={t['error']!r}" if t.get("error") else ""
    return (
        f"  #{t['id']} {t['type']:16} vol={t['volume_id']:<6} "
        f"{t['state']:9} age={age:6.1f}s {t['reason']}{extra}{err}\n"
    )


@command(
    "maintenance.status",
    "maintenance.status [-server url] [-history n] "
    "# queue, running tasks, history ring",
)
def cmd_maintenance_status(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="maintenance.status")
    p.add_argument("-server", default="")
    p.add_argument("-history", type=int, default=10)
    opts = p.parse_args(args)
    view = _fetch(env, opts.server)
    now = time.time()
    state = "disabled"
    if view.get("enabled"):
        state = "paused" if view.get("paused") else "running"
    gate = view.get("gate")
    out.write(
        f"maintenance: {state}"
        + (f" (gated: {gate})" if gate else "")
        + f" · rounds={view.get('rounds', 0)}"
        + f" · backlog={view.get('backlog_seconds', 0.0):.1f}s\n"
    )
    counters = view.get("counters") or {}
    out.write(
        "totals: "
        + " ".join(
            f"{k}={counters.get(k, 0)}"
            for k in ("completed", "failed", "skipped")
        )
        + "\n"
    )
    for title, key in (
        ("running", "running"), ("queued", "queued"),
    ):
        rows = view.get(key) or []
        out.write(f"{title} ({len(rows)}):\n")
        for t in rows:
            out.write(_task_row(t, now))
    hist = (view.get("history") or [])[-opts.history:]
    out.write(f"history (last {len(hist)}):\n")
    for t in hist:
        out.write(_task_row(t, now))


@command("maintenance.pause", "maintenance.pause # stop dispatching tasks")
def cmd_maintenance_pause(env: CommandEnv, args: list[str], out) -> None:
    _post(env, {"action": "pause"})
    out.write("maintenance paused\n")


@command("maintenance.resume", "maintenance.resume # resume dispatching")
def cmd_maintenance_resume(env: CommandEnv, args: list[str], out) -> None:
    _post(env, {"action": "resume"})
    out.write("maintenance resumed\n")


@command(
    "maintenance.policy",
    "maintenance.policy [-set key=value ...] # show or update the policy",
)
def cmd_maintenance_policy(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="maintenance.policy")
    p.add_argument("-server", default="")
    p.add_argument(
        "-set", dest="updates", action="append", default=[],
        metavar="key=value",
    )
    opts = p.parse_args(args)
    if not opts.updates:
        policy = _fetch(env, opts.server).get("policy") or {}
        for k in sorted(policy):
            out.write(f"{k} = {policy[k]}\n")
        return
    updates: dict = {}
    for item in opts.updates:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"-set wants key=value, got {item!r}")
        updates[key.strip()] = value.strip()
    res = _post(
        env, {"action": "policy", "policy": updates}, opts.server
    )
    for k in sorted(updates):
        out.write(f"{k} = {res['policy'][k]}\n")


@command(
    "maintenance.run",
    "maintenance.run [type] # force one detector round "
    "(optionally a single task type)",
)
def cmd_maintenance_run(env: CommandEnv, args: list[str], out) -> None:
    p = argparse.ArgumentParser(prog="maintenance.run")
    p.add_argument("type", nargs="?", default="")
    p.add_argument("-server", default="")
    opts = p.parse_args(args)
    payload: dict = {"action": "run"}
    if opts.type:
        payload["type"] = opts.type
    res = _post(env, payload, opts.server)
    enqueued = res.get("enqueued") or []
    if not enqueued:
        out.write("nothing detected\n")
        return
    for t in enqueued:
        out.write(
            f"queued #{t['id']} {t['type']} vol={t['volume_id']}: "
            f"{t['reason']}\n"
        )
