"""Profiling endpoints served by every server's router.

The reference arms net/http/pprof handlers behind its grace hooks
(weed/util/grace/pprof.go:11-33 — cpu/mem profiles on shutdown); the
Python runtime's equivalents are served live:

* ``GET /debug/stacks`` — a plain-text dump of every thread's current
  stack (the `goroutine` profile analog): the first thing to pull on a
  wedged server.
* ``GET /debug/vars``   — process gauges as JSON (expvar analog): RSS,
  thread count, GC counters, per-role uptimes, device link health
  (ops/link.py probe + EWMAs), and circuit-breaker state.
* ``GET /debug/slow``   — the slow-request ledger (telemetry/slow.py).

Wired by the tracing middleware (`instrument`), prepended ahead of
catch-all data-plane routes like the other reserved paths.

The port's copy of ``seaweedfs_tpu/telemetry/debug.py``. Its
``/debug/devices`` serves the port's own dispatch ledger, whose rows
are labelled by device position.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

from ..util.http import Request, Response
from . import slow


def handle_slow(req: Request) -> Response:
    try:
        limit = int(req.param("limit", "0") or 0)
    except ValueError:
        limit = 0
    return Response.json({"slow": slow.LEDGER.entries(limit=limit)})


def handle_stacks(req: Request) -> Response:
    """All-thread stack dump, newest frame last per thread."""
    threads = {t.ident: t for t in threading.enumerate()}
    lines = [f"==== {len(threads)} threads @ {time.time():.3f} ===="]
    for tid, frame in sorted(sys._current_frames().items()):
        t = threads.get(tid)
        name = t.name if t else "?"
        daemon = t.daemon if t else "?"
        lines.append(f"\n-- Thread {name} (id={tid} daemon={daemon}) --")
        lines.extend(
            ln.rstrip() for ln in traceback.format_stack(frame)
        )
    return Response(
        status=200,
        body=("\n".join(lines) + "\n").encode(),
        headers={"Content-Type": "text/plain; charset=utf-8"},
    )


def handle_vars(req: Request) -> Response:
    from ..util import retry as retry_mod
    from . import recorder as flight
    from .snapshot import (
        component_uptimes,
        link_snapshot,
        process_stats,
    )

    return Response.json(
        {
            "time": time.time(),
            "process": process_stats(),
            "uptime_seconds": component_uptimes(),
            "link_health": link_snapshot(),
            "breakers": retry_mod.BREAKERS.snapshot(),
            "slow_ledger_size": len(slow.LEDGER.entries()),
            # flight-recorder state + where to read its frames
            "recorder": dict(
                flight.RECORDER.state(),
                endpoint="/debug/timeline?seconds=60",
            ),
        }
    )


def handle_timeline(req: Request) -> Response:
    """Recent flight-recorder frames (``?seconds=N`` trailing window)
    plus ring state — the JSON the shell's ``cluster.timeline``
    sparklines are drawn from."""
    from . import recorder as flight

    try:
        seconds = float(req.param("seconds", "60") or 60)
    except ValueError:
        seconds = 60.0
    return Response.json(
        dict(
            flight.RECORDER.state(),
            window_seconds=seconds,
            recent=flight.RECORDER.frames(seconds=seconds),
            sample_cost_ms=flight.RECORDER.sample_cost_ms(),
        )
    )


def handle_contention(req: Request) -> Response:
    """Top-contended lock sites from the runtime witness
    (``?top=N``); also pushes the per-site wait buckets into the
    ``seaweedfs_lock_wait_seconds`` family so a scrape right after
    this read sees the same picture."""
    from . import recorder as flight

    try:
        top = int(req.param("top", "10") or 10)
    except ValueError:
        top = 10
    flight.sync_lock_metrics()
    rows = flight.contention_table(top=top)
    return Response.json({
        "witness_installed": bool(rows) or _witness_installed(),
        "sites": len(rows),
        "top": rows,
    })


def handle_devices(req: Request) -> Response:
    """The per-chip dispatch ledger (``telemetry/devices.py``):
    per-device busy/launch/transfer rows, host staging lanes, and the
    busy-imbalance aggregate — the JSON ``weed shell cluster.devices``
    renders."""
    from . import devices

    return Response.json(devices.LEDGER.snapshot())


def _witness_installed() -> bool:
    from ..util import lockwitness

    w = lockwitness.current()
    return w is not None and w.installed
