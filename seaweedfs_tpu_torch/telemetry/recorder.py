"""In-process cluster flight recorder: the instrument the scale arc
reads when a fleet melts.

SCALE rounds used to reduce a 100-server churn run to one
converge-seconds number; when that regresses at 500–1000 servers
nothing said *which* subsystem melted. The recorder answers that: a
bounded ring of per-sample **frames** (monotonic timestamp + every
registered probe's value) captured by one daemon sampler thread at a
configurable rate (1–4 Hz), cheap enough to stay attached for a whole
round.

Three probe sources feed each frame:

* **registered probes** — callables server roles attach at start and
  remove at stop (master: telemetry-aggregator lock wait, heartbeat
  fan-in rate, broadcaster replay-log size, maintenance queue +
  repair backlog, breaker open-count); ``kind="counter"`` probes are
  differenced into per-second rates, ``kind="gauge"`` probes are
  recorded as-is;
* **the metrics registry** — every ``stats/metrics.py`` counter
  (as ``m.<name>`` rate) and gauge (as ``g.<name>``), so anything
  already instrumented shows up in the timeline for free;
* **process vitals** — RSS, thread count, and open-fd count (from
  ``/proc/self/fd``; the fd/thread peaks over a round are gated by
  ``util/benchgate.py``, the per-site leak attribution lives in
  ``util/reswitness.py``), always on.

The recorder pairs with the lock-contention profiler grown into
``util/lockwitness.py``: ``sync_lock_metrics()`` publishes the
witness's per-site wait buckets as ``seaweedfs_lock_wait_seconds{site}``
(site labels are canonical creation sites from the lock index — a
bounded set — never raw ``id()``s), and ``contention_table()`` renders
the top-contended sites with wait p50/p99, hold totals, and the
blocked thread's stack fingerprint. ``scale/round.py`` embeds both as
the ``timeline`` and ``contention`` sections of SCALE_rNN.json, gated
by ``util/benchgate.py``; ``weed shell`` renders them as
``cluster.timeline`` / ``cluster.contention``.

Probes are CALLED with no recorder lock held (a slow or lock-taking
probe must never couple the recorder to the subsystem it watches);
each sampling pass times itself so overhead is a recorded fact
(``sample_cost_ms``), not a hope.

The port's copy of ``seaweedfs_tpu/telemetry/recorder.py``, on the
port's metrics registry, span histogram and lock witness.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..stats.metrics import Counter as _MCounter
from ..stats.metrics import Gauge as _MGauge
from ..stats.metrics import REGISTRY
from ..tracing.recorder import SPAN_SECONDS
from ..util import lockwitness
from .snapshot import merge_histogram, process_stats, quantile

LOCK_WAIT_SECONDS = REGISTRY.histogram(
    "seaweedfs_lock_wait_seconds",
    "Time threads spent blocked acquiring package locks, by creation "
    "site (lock witness contention profiler).",
    ("site",),
    start=lockwitness.WAIT_BUCKET_START,
    factor=2.0,
    count=lockwitness.WAIT_BUCKET_COUNT,
)
RECORDER_FRAMES = REGISTRY.gauge(
    "seaweedfs_recorder_frames",
    "Frames currently held in the flight-recorder ring.",
)
RECORDER_SAMPLE_SECONDS = REGISTRY.histogram(
    "seaweedfs_recorder_sample_seconds",
    "Cost of one flight-recorder sampling pass.",
)


def _probe_rss_mb() -> float:
    return process_stats()["rss_bytes"] / (1024.0 * 1024.0)


def _probe_threads() -> float:
    return float(threading.active_count())


def _probe_fds() -> float:
    # /proc/self/fd is Linux-only; on other platforms the raised
    # OSError makes sample() skip the probe, so timelines simply lack
    # an fds series rather than recording garbage
    return float(len(os.listdir("/proc/self/fd")))


class FlightRecorder:
    """Bounded-ring time-series sampler. One instance per process
    (module-level ``RECORDER``); roles attach probes, the scale
    harness starts/stops the sampler thread around a round."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        # name -> (callable, "gauge"|"counter")  # guarded-by: self._lock
        self._probes: dict[str, tuple] = {
            "rss_mb": (_probe_rss_mb, "gauge"),
            "threads": (_probe_threads, "gauge"),
            "fds": (_probe_fds, "gauge"),
        }
        self._prev_raw: dict[str, float] = {}  # guarded-by: self._lock
        self._prev_t: float | None = None  # guarded-by: self._lock
        self._costs: deque = deque(maxlen=256)  # guarded-by: self._lock
        self._thread: threading.Thread | None = None  # guarded-by: self._lock
        self._stop = threading.Event()
        self._hz = 0.0  # guarded-by: self._lock
        self._components: set[str] = set()  # guarded-by: self._lock

    # -- probes ----------------------------------------------------------

    def register_probe(self, name: str, fn, kind: str = "gauge") -> None:
        """Attach a probe; ``kind="counter"`` values are differenced
        into per-second rates frame-to-frame."""
        with self._lock:
            self._probes[name] = (fn, kind)

    def remove_probe(self, name: str, fn=None) -> None:
        """Detach a probe; when ``fn`` is given, only if it is still
        OURS (a restarted role re-registers under the same name and
        the stop of the old instance must not tear the new one down)."""
        with self._lock:
            ent = self._probes.get(name)
            if ent is not None and (fn is None or ent[0] is fn):
                del self._probes[name]

    def attach_component(self, component: str) -> None:
        """Give a server role a request-rate probe
        (``<component>_req_hz``) fed by the span-latency family.
        Idempotent per component; called from ``mark_started``."""
        with self._lock:
            if component in self._components:
                return
            self._components.add(component)

        def req_total(c=component):
            _counts, total, _sm = merge_histogram(SPAN_SECONDS, c)
            return float(total)

        self.register_probe(f"{component}_req_hz", req_total,
                            kind="counter")

    # -- sampling --------------------------------------------------------

    def sample(self) -> dict:
        """Take one frame: run every probe, sweep the metrics
        registry, difference counters into rates. Probes run with NO
        recorder lock held; a failing probe is skipped, not fatal."""
        t0 = time.perf_counter()
        now = time.monotonic()
        with self._lock:
            probes = list(self._probes.items())
            prev_raw = self._prev_raw
            prev_t = self._prev_t
        dt = (now - prev_t) if prev_t is not None else 0.0
        raw: dict[str, float] = {}
        frame: dict = {"t": round(now, 4)}
        for name, (fn, kind) in probes:
            try:
                v = float(fn())
            except Exception:
                continue
            if kind == "counter":
                raw[name] = v
                if dt > 0 and name in prev_raw:
                    frame[name] = round(
                        max(0.0, v - prev_raw[name]) / dt, 3
                    )
            else:
                frame[name] = round(v, 3)
        for fam in REGISTRY.families():
            if isinstance(fam, _MCounter):
                total = sum(fam.values().values())
                if total == 0:
                    continue
                key = "m." + fam.name
                raw[key] = total
                if dt > 0 and key in prev_raw:
                    rate = max(0.0, total - prev_raw[key]) / dt
                    if rate > 0:
                        frame[key] = round(rate, 3)
            elif isinstance(fam, _MGauge):
                vals = fam.values()
                if vals:
                    frame["g." + fam.name] = round(
                        sum(vals.values()), 3
                    )
        cost = time.perf_counter() - t0
        with self._lock:
            self._prev_raw = raw
            self._prev_t = now
            self._frames.append(frame)
            self._costs.append(cost)
            n_frames = len(self._frames)
        RECORDER_FRAMES.set(float(n_frames))
        RECORDER_SAMPLE_SECONDS.observe(cost)
        return frame

    def _run(self, period: float, stop: threading.Event) -> None:
        while not stop.wait(period):
            self.sample()

    def start(self, hz: float = 2.0) -> None:
        """Start the sampler thread at ``hz`` frames/second.
        Idempotent while running."""
        if hz <= 0:
            return
        with self._lock:
            if self._thread is not None:
                return
            stop = threading.Event()
            t = threading.Thread(
                target=self._run, args=(1.0 / hz, stop),
                name="flight-recorder", daemon=True,
            )
            self._stop = stop
            self._thread = t
            self._hz = hz
        t.start()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            stop = self._stop
            self._thread = None
            self._hz = 0.0
        stop.set()
        if t is not None:
            t.join(timeout=5.0)

    # -- views -----------------------------------------------------------

    def frames(self, since: float | None = None,
               seconds: float | None = None) -> list[dict]:
        """Recent frames, oldest first; ``since`` filters on the
        monotonic timestamp, ``seconds`` keeps the trailing window."""
        with self._lock:
            out = list(self._frames)
        if since is not None:
            out = [f for f in out if f["t"] >= since]
        if seconds is not None:
            horizon = time.monotonic() - seconds
            out = [f for f in out if f["t"] >= horizon]
        return out

    def sample_cost_ms(self) -> dict:
        with self._lock:
            costs = list(self._costs)
        if not costs:
            return {"mean": 0.0, "max": 0.0}
        return {
            "mean": round(1e3 * sum(costs) / len(costs), 4),
            "max": round(1e3 * max(costs), 4),
        }

    def state(self) -> dict:
        with self._lock:
            return {
                "running": self._thread is not None,
                "hz": self._hz,
                "frames": len(self._frames),
                "capacity": self._frames.maxlen,
                "probes": sorted(self._probes),
            }


RECORDER = FlightRecorder()


def attach_component(component: str) -> None:
    RECORDER.attach_component(component)


# -- timeline rendering ---------------------------------------------------


def _downsample_max(vals: list[float], cells: int) -> list[float]:
    """Max-pool a series down to <= cells points: a one-frame spike
    (the repair-backlog peak) must survive downsampling."""
    if len(vals) <= cells:
        return [round(v, 3) for v in vals]
    n = len(vals)
    out = []
    for i in range(cells):
        lo = i * n // cells
        hi = max(lo + 1, (i + 1) * n // cells)
        out.append(round(max(vals[lo:hi]), 3))
    return out


def build_timeline(frames: list[dict], hz: float = 0.0,
                   buckets: int = 60, costs: dict | None = None) -> dict:
    """The ``timeline`` section of a SCALE round: per-probe peak /
    mean / last plus a max-downsampled series (<= ``buckets`` cells),
    and the recorder's own measured sampling cost."""
    names: set[str] = set()
    for f in frames:
        names.update(k for k in f if k != "t")
    span = frames[-1]["t"] - frames[0]["t"] if len(frames) >= 2 else 0.0
    probes: dict[str, dict] = {}
    for name in sorted(names):
        vals = [f[name] for f in frames if name in f]
        probes[name] = {
            "peak": max(vals),
            "mean": round(sum(vals) / len(vals), 4),
            "last": vals[-1],
            "series": _downsample_max(vals, buckets),
        }
    out = {
        "hz": hz,
        "frames": len(frames),
        "span_seconds": round(span, 3),
        "probes": probes,
        "peaks": {n: p["peak"] for n, p in probes.items()},
    }
    if costs is not None:
        out["sample_cost_ms"] = costs
    return out


# -- contention profiler views --------------------------------------------


def contention_baseline(witness=None) -> dict:
    """Snapshot to diff a later ``contention_table`` against (the
    witness is process-global; a round wants only ITS waits)."""
    w = witness if witness is not None else lockwitness.current()
    return w.contention_snapshot() if w is not None else {}


def contention_table(baseline: dict | None = None, top: int = 0,
                     witness=None) -> list[dict]:
    """Top-contended lock sites, most total wait first. Each row:
    blocked/acquire counts, total/max wait, bucket-estimated p50/p99
    wait, hold totals, and the first slow blocked stack fingerprint."""
    w = witness if witness is not None else lockwitness.current()
    if w is None:
        return []
    base = baseline or {}
    rows: list[dict] = []
    for short, d in w.contention_snapshot().items():
        b = base.get(short)
        if b is not None:
            d = dict(d)
            for k in ("acquires", "blocked", "wait_sum",
                      "hold_count", "hold_sum"):
                d[k] -= b[k]
            d["wait_buckets"] = [
                x - y for x, y in zip(d["wait_buckets"],
                                      b["wait_buckets"])
            ]
            if d["acquires"] < 0:
                continue  # witness reset between snapshots
        if d["acquires"] <= 0:
            continue
        blocked = max(0, d["blocked"])
        buckets = [max(0, c) for c in d["wait_buckets"]]
        rows.append({
            "site": short,
            "kind": d["kind"],
            "acquires": d["acquires"],
            "blocked": blocked,
            "total_wait_s": round(max(0.0, d["wait_sum"]), 6),
            "max_wait_s": round(d["wait_max"], 6),
            "p50_wait_s": round(quantile(
                lockwitness.WAIT_BOUNDS, buckets, blocked, 0.5
            ), 6) if blocked else 0.0,
            "p99_wait_s": round(quantile(
                lockwitness.WAIT_BOUNDS, buckets, blocked, 0.99
            ), 6) if blocked else 0.0,
            "hold_count": d["hold_count"],
            "total_hold_s": round(max(0.0, d["hold_sum"]), 6),
            "max_hold_s": round(d["hold_max"], 6),
            "stack": d["blocked_stack"],
        })
    rows.sort(key=lambda r: r["total_wait_s"], reverse=True)
    return rows[:top] if top else rows


def contention_section(baseline: dict | None = None, top: int = 8,
                       witness=None) -> dict:
    """The ``contention`` section of a SCALE round: top sites plus
    the two gated aggregates (total wait, worst top-site p99)."""
    rows = contention_table(baseline=baseline, witness=witness)
    topped = rows[:top]
    return {
        "sites": len(rows),
        "total_wait_s": round(
            sum(r["total_wait_s"] for r in rows), 6
        ),
        "p99_wait_s": max(
            (r["p99_wait_s"] for r in topped), default=0.0
        ),
        "top": topped,
    }


# delta bookkeeping for the published histogram: last (buckets,
# blocked, wait_sum) pushed per site
_SYNC_LOCK = threading.Lock()
_published: dict[str, tuple] = {}  # guarded-by: _SYNC_LOCK


def sync_lock_metrics() -> int:
    """Publish the witness's per-site wait buckets into
    ``seaweedfs_lock_wait_seconds{site}`` as deltas since the last
    sync. Site labels come from the canonical lock index (bounded:
    one per creation site). Returns the number of sites that moved.
    The family merge runs AFTER the bookkeeping lock is released."""
    w = lockwitness.current()
    if w is None:
        return 0
    snap = w.contention_snapshot()
    deltas: list[tuple] = []
    with _SYNC_LOCK:
        for short, d in snap.items():
            prev = _published.get(short)
            if prev is None:
                db = list(d["wait_buckets"])
                dn = d["blocked"]
                ds = d["wait_sum"]
            else:
                db = [a - b for a, b in zip(d["wait_buckets"], prev[0])]
                dn = d["blocked"] - prev[1]
                ds = d["wait_sum"] - prev[2]
                if dn < 0 or any(x < 0 for x in db):  # witness reset
                    db = list(d["wait_buckets"])
                    dn = d["blocked"]
                    ds = d["wait_sum"]
            _published[short] = (
                list(d["wait_buckets"]), d["blocked"], d["wait_sum"]
            )
            if dn > 0 or any(db):
                deltas.append((short, db, dn, ds))
    for short, db, dn, ds in deltas:
        LOCK_WAIT_SECONDS.merge_counts(db, dn, max(0.0, ds), short)
    return len(deltas)
