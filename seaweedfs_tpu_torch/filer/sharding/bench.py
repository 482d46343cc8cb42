"""Metadata-plane throughput bench for the sharded filer tier.

Measures pure metadata ops/s (``?entry=true`` writes + ``?meta=true``
reads — no volume I/O, no master round-trips) against an N-shard
filer tier, each shard a REAL server process owning its own sqlite
file. Shards run as subprocesses, not in-process threads: the whole
point of the tier is that shards don't share anything — not a store
lock, and in this interpreter's case not a GIL — so an in-process
"tier" would measure interpreter contention, not the metadata plane.

The workload spreads keys over many TOP-LEVEL directories because the
ShardMap routes on the first path segment — a single hot directory
would (correctly) land on one shard and measure nothing. Clients keep
one persistent connection per (worker, shard): the tier's consumers
are long-lived gateways, not connect-per-request scripts.

The port's copy of ``seaweedfs_tpu/filer/sharding/bench.py``.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

from .ring import ShardMap

_SHARD_MAIN = """\
import sys, time
from seaweedfs_tpu_torch.filer.stores import SqliteStore
from seaweedfs_tpu_torch.server.filer import FilerServer

db, idx, of = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
fs = FilerServer(
    "127.0.0.1:1",  # metadata-only ops never touch the master
    store=SqliteStore(db),
    shard=(idx, of),
    telemetry_interval=0,
    watch_locations=False,
)
fs.start()
print(fs.url, flush=True)
time.sleep(3600)
"""


def _spawn_shard(root: str, i: int, n: int) -> tuple:
    """One shard server in its own process; returns (proc, url)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            )))
        )
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    proc = subprocess.Popen(
        [
            sys.executable, "-c", _SHARD_MAIN,
            os.path.join(root, f"shard{i}.db"), str(i), str(n),
        ],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        env=env,
        text=True,
    )
    url = (proc.stdout.readline() or "").strip()
    if not url:
        proc.kill()
        raise RuntimeError(f"filer shard {i} failed to start")
    return proc, url


def measure_meta_ops(
    n_shards: int,
    seconds: float = 2.0,
    threads: int = 8,
    top_dirs: int = 16,
) -> float:
    """Sustained metadata ops/s of an `n_shards` filer tier.

    Spawns the tier (one server process per shard), hammers it from
    `threads` workers with a write-then-read-back loop across
    `top_dirs` top-level directories, and returns completed ops per
    second over the measured window."""
    root = tempfile.mkdtemp(prefix="swtpu_filer_bench_")
    procs = []
    try:
        urls = []
        for i in range(n_shards):
            proc, url = _spawn_shard(root, i, n_shards)
            procs.append(proc)
            urls.append(url)
        smap = ShardMap(urls)
        counts = [0] * threads
        stop = threading.Event()

        def worker(w: int) -> None:
            conns: dict[str, http.client.HTTPConnection] = {}
            seq = 0
            while not stop.is_set():
                d = (w * 7 + seq) % top_dirs
                path = f"/d{d:02d}/w{w}_{seq}"
                base = smap.url_for(path)
                conn = conns.get(base)
                if conn is None:
                    host, port = base.rsplit(":", 1)
                    conn = http.client.HTTPConnection(
                        host, int(port), timeout=10
                    )
                    try:
                        conn.connect()
                        conn.sock.setsockopt(
                            socket.IPPROTO_TCP,
                            socket.TCP_NODELAY, 1,
                        )
                    except OSError:
                        continue
                    conns[base] = conn
                body = json.dumps(
                    {"full_path": path, "attr": {"mode": 0o644}}
                )
                try:
                    conn.request(
                        "POST", f"{path}?entry=true", body,
                        {"Content-Type": "application/json"},
                    )
                    conn.getresponse().read()
                    conn.request("GET", f"{path}?meta=true")
                    conn.getresponse().read()
                except (OSError, http.client.HTTPException):
                    conns.pop(base, None)
                    continue  # errored ops don't count
                counts[w] += 2
                seq += 1
            for c in conns.values():
                c.close()

        pool = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(threads)
        ]
        t0 = time.monotonic()
        for t in pool:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in pool:
            t.join(timeout=10)
        elapsed = time.monotonic() - t0
        return sum(counts) / max(elapsed, 1e-9)
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
        shutil.rmtree(root, ignore_errors=True)
