"""Command environment, registry, and cluster lock.

Behavioral model: weed/shell/commands.go:26-80 (command interface,
confirmIsLocked), weed/wdclient/exclusive_locks (lease via master).

The port's copy of ``seaweedfs_tpu/shell/commands.py``. It registers
only the ported command modules (``command_ec``); any other name raises
the same ``unknown command`` error the reference raises for a name it
does not know.
"""

from __future__ import annotations

import io
import shlex
import uuid
from typing import Callable

from ..util import http

COMMANDS: dict[str, Callable] = {}
COMMAND_HELP: dict[str, str] = {}


def command(name: str, help_text: str = ""):
    def deco(fn):
        COMMANDS[name] = fn
        COMMAND_HELP[name] = help_text or (fn.__doc__ or "").strip()
        return fn

    return deco


class CommandEnv:
    def __init__(self, master_url: str):
        self.master_url = master_url
        self.client_id = f"shell-{uuid.uuid4().hex[:8]}"
        self._locked = False

    # -- master helpers --------------------------------------------------

    def topology(self) -> dict:
        return http.get_json(f"{self.master_url}/topology")

    def data_nodes(self) -> list[dict]:
        out = []
        for dc in self.topology()["data_centers"]:
            for rack in dc["racks"]:
                for dn in rack["data_nodes"]:
                    dn = dict(dn)
                    dn["dc"] = dc["id"]
                    dn["rack"] = rack["id"]
                    out.append(dn)
        return out

    # -- cluster lock (commands.go:70-77) --------------------------------

    def lock(self) -> None:
        http.post_json(
            f"{self.master_url}/cluster/lock", {"client": self.client_id}
        )
        self._locked = True

    def unlock(self) -> None:
        if self._locked:
            http.post_json(
                f"{self.master_url}/cluster/unlock",
                {"client": self.client_id},
            )
            self._locked = False

    def confirm_is_locked(self) -> None:
        if not self._locked:
            raise RuntimeError(
                "lock is lost, or not locked; run `lock` first"
            )


def all_commands() -> dict[str, str]:
    # import side-effect registration
    from . import command_ec  # noqa: F401

    return dict(COMMAND_HELP)


def run_command(env: CommandEnv, line: str) -> str:
    """Parse + run one shell line; returns its output text."""
    all_commands()
    parts = shlex.split(line)
    if not parts:
        return ""
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        return "\n".join(
            f"{k}\t{v.splitlines()[0] if v else ''}"
            for k, v in sorted(all_commands().items())
        )
    if name == "lock":
        env.lock()
        return "locked"
    if name == "unlock":
        env.unlock()
        return "unlocked"
    fn = COMMANDS.get(name)
    if fn is None:
        raise ValueError(f"unknown command: {name}")
    out = io.StringIO()
    fn(env, args, out)
    return out.getvalue()
