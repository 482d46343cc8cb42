"""Stdlib sampling profiler served as ``/debug/profile?seconds=N``.

The in-process analog of the reference's ``/debug/pprof/profile``
(weed/util/grace/pprof.go): for N seconds, periodically snapshot every
thread's stack via ``sys._current_frames()`` and aggregate the samples
into **folded-stack text** — one line per distinct stack,
``thread;frame;frame;... count`` root→leaf, the format flamegraph.pl /
speedscope / inferno consume directly. Where ``/debug/stacks`` answers
"what is every thread doing right now", this answers "where does this
server actually SPEND its time" — the question the whole speed arc
(wired-path streaming, hot-path QPS) is gated on.

Pure stdlib and allocation-light: sampling cost is O(threads x depth)
per tick at the default 100 Hz, cheap enough to run against a loaded
server. Served on every server by the tracing middleware
(`tracing/middleware.instrument`), and rendered by ``weed shell
cluster.profile``.

The port's copy of ``seaweedfs_tpu/telemetry/profile.py``.
"""

from __future__ import annotations

import os
import sys
import threading
import time

# request bounds: a profile holds one handler thread for its whole
# window, so cap how long/hot a single request can sample
MAX_SECONDS = 60.0
MAX_HZ = 1000
DEFAULT_SECONDS = 5.0
DEFAULT_HZ = 100


def _frame_label(frame) -> str:
    code = frame.f_code
    return (
        f"{os.path.basename(code.co_filename)}:{code.co_name}"
    )


def collect_samples(
    seconds: float,
    hz: int = DEFAULT_HZ,
    stop=None,
) -> tuple[dict[str, int], int]:
    """Sample all threads for ``seconds``; returns (folded-stack →
    sample count, ticks taken). The sampling thread itself is
    excluded — it would otherwise dominate its own profile. ``stop``
    (threading.Event) ends the window early."""
    interval = 1.0 / max(1, min(int(hz), MAX_HZ))
    deadline = time.monotonic() + max(0.0, min(seconds, MAX_SECONDS))
    me = threading.get_ident()
    agg: dict[str, int] = {}
    ticks = 0
    names = {t.ident: t.name for t in threading.enumerate()}
    while time.monotonic() < deadline:
        if stop is not None and stop.is_set():
            break
        frames = sys._current_frames()
        for tid, frame in frames.items():
            if tid == me:
                continue
            stack = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                stack.append(_frame_label(f))
                f = f.f_back
                depth += 1
            stack.reverse()  # root -> leaf, the folded convention
            name = names.get(tid)
            if name is None:
                names = {
                    t.ident: t.name for t in threading.enumerate()
                }
                name = names.get(tid, f"tid-{tid}")
            key = ";".join([name] + stack)
            agg[key] = agg.get(key, 0) + 1
        ticks += 1
        # frame walking took part of the tick already; a plain sleep
        # keeps the cadence close enough for aggregate attribution
        time.sleep(interval)
    return agg, ticks


def render_folded(agg: dict[str, int]) -> str:
    """Folded-stack text, heaviest stacks first."""
    lines = [
        f"{stack} {count}"
        for stack, count in sorted(
            agg.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def handle_profile(req):
    """``GET /debug/profile?seconds=N&hz=M`` → text/plain folded
    stacks (the request blocks while the window samples, like
    /debug/pprof/profile)."""
    from ..util.http import Response

    try:
        seconds = float(req.param("seconds", "") or DEFAULT_SECONDS)
    except ValueError:
        seconds = DEFAULT_SECONDS
    try:
        hz = int(req.param("hz", "") or DEFAULT_HZ)
    except ValueError:
        hz = DEFAULT_HZ
    seconds = max(0.05, min(seconds, MAX_SECONDS))
    agg, ticks = collect_samples(seconds, hz)
    header = (
        f"# folded stacks: {sum(agg.values())} samples over "
        f"{ticks} ticks ({seconds:g}s @ {min(max(1, hz), MAX_HZ)}Hz); "
        f"feed to flamegraph.pl / speedscope\n"
    )
    return Response(
        status=200,
        body=(header + render_folded(agg)).encode(),
        headers={"Content-Type": "text/plain; charset=utf-8"},
    )


def top_functions(agg: dict[str, int], limit: int = 15) -> list[tuple[str, int]]:
    """Leaf-frame attribution (self samples), heaviest first — the
    quick `where is the CPU going` view cluster.profile prints."""
    leaves: dict[str, int] = {}
    for stack, count in agg.items():
        leaf = stack.rsplit(";", 1)[-1]
        leaves[leaf] = leaves.get(leaf, 0) + count
    return sorted(
        leaves.items(), key=lambda kv: (-kv[1], kv[0])
    )[:limit]
