"""Per-server telemetry snapshots: the unit the cluster view aggregates.

Each server periodically assembles one JSON-able snapshot — request
p50/p99 and interval deltas from the span-latency histogram, error
rates, uptime, process stats (RSS / thread count / GC), the codec
link-health EWMAs, circuit-breaker state, and injected-fault counters —
and ships it to the master: volume servers piggyback it on the
heartbeat (pb/messages.py `Heartbeat.telemetry`), filer and S3 push it
via `telemetry/reporter.py`. The reference's per-server stats handlers
(weed/stats/metrics.go:19-123) publish to a push gateway; here the
master IS the aggregation point, so no extra infrastructure runs.

Also home to the process-identity families every dashboard keys on:
``seaweedfs_build_info{version,platform,jax_backend}`` and
``seaweedfs_server_uptime_seconds{component}``, set at server startup
via :func:`mark_started`.

The port's copy of ``seaweedfs_tpu/telemetry/snapshot.py``, on the
port's registry, span recorder, breakers, fault switchboard and
``ops/link.py``. ``seaweedfs_build_info`` keeps its three label names;
its third, ``jax_backend``, carries the port's platform (``cuda`` or
``cpu``, :func:`backend`).
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from collections import deque

from .. import __version__
from ..stats.metrics import REGISTRY, Histogram
from ..tracing.recorder import SPAN_ERRORS, SPAN_SECONDS
from ..util import retry as retry_mod
from . import slow

BUILD_INFO = REGISTRY.gauge(
    "seaweedfs_build_info",
    "Build identity (always 1); labels carry version/platform/backend.",
    ("version", "platform", "jax_backend"),
)
UPTIME = REGISTRY.gauge(
    "seaweedfs_server_uptime_seconds",
    "Seconds since each server role started in this process.",
    ("component",),
)

_lock = threading.Lock()
_started: dict[str, float] = {}  # component -> start epoch  # guarded-by: _lock
# component -> monotonic start; uptimes are DURATIONS, so they come
# from the monotonic clock while _started keeps the display epoch
_started_mono: dict[str, float] = {}  # guarded-by: _lock


def backend() -> str:
    """The port's platform, ``cuda`` or ``cpu``, read WITHOUT
    initializing CUDA (``torch.cuda.is_available`` asks CUDA for a device
    count and creates no context): the control plane must never
    pay device init for a label value. It fills the ``jax_backend``
    label, whose name dashboards key on."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "not-loaded"
    try:
        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "error"


def mark_started(component: str) -> None:
    """Record a server role's start: feeds the uptime gauge and stamps
    the build-info family. Idempotent per component (restart of an
    in-proc server keeps the original epoch)."""
    with _lock:
        _started.setdefault(component, time.time())
        _started_mono.setdefault(component, time.monotonic())
    BUILD_INFO.set(1.0, __version__, sys.platform, backend())
    # every started role shows up in the flight recorder's timeline
    # with a request-rate probe (lazy import: recorder imports us)
    from . import recorder as flight

    flight.attach_component(component)


def started_components() -> dict[str, float]:
    with _lock:
        return dict(_started)


def component_uptimes() -> dict[str, float]:
    """Seconds each server role has been up, on the monotonic clock."""
    now = time.monotonic()
    with _lock:
        return {
            component: round(now - t0, 3)
            for component, t0 in _started_mono.items()
        }


def update_uptime() -> None:
    for component, up in component_uptimes().items():
        UPTIME.set(up, component)


def metrics_response():
    """The shared `/metrics` handler body: refresh the uptime gauges,
    then expose the whole registry (prometheus text format)."""
    from ..util.http import Response

    update_uptime()
    return Response(
        status=200,
        body=REGISTRY.expose().encode(),
        headers={"Content-Type": "text/plain; version=0.0.4"},
    )


def process_stats() -> dict:
    """RSS / thread count / GC counters for this process."""
    rss = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        try:
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, ValueError):
            rss = 0
    collections = collected = uncollectable = 0
    for g in gc.get_stats():
        collections += g.get("collections", 0)
        collected += g.get("collected", 0)
        uncollectable += g.get("uncollectable", 0)
    return {
        "rss_bytes": rss,
        "threads": threading.active_count(),
        "gc_collections": collections,
        "gc_collected": collected,
        "gc_uncollectable": uncollectable,
    }


def quantile(bounds: list[float], counts: list[int], total: int,
             q: float) -> float:
    """Bucket-quantile estimate: the smallest bound whose cumulative
    count reaches rank q*total (the standard prometheus upper-bound
    estimate). Overflow past every finite bound clamps to the largest
    bound — a finite, renderable, JSON-safe answer."""
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for b, c in zip(bounds, counts):
        cum += c
        if cum >= rank:
            return b
    return float(bounds[-1]) if bounds else 0.0


def merge_histogram(
    hist: Histogram, label_value: str | None = None, label_index: int = 0
) -> tuple[list[int], int, float]:
    """Merge a histogram's label sets into one (counts, total, sum),
    optionally keeping only keys whose `label_index` label equals
    `label_value` — e.g. one component's slice of the span family."""
    counts = [0] * len(hist.buckets)
    total = 0
    sm = 0.0
    for key, (c, tot, s) in hist.snapshot().items():
        if label_value is not None and (
            not key or key[label_index] != label_value
        ):
            continue
        counts = [a + b for a, b in zip(counts, c)]
        total += tot
        sm += s
    return counts, total, sm


def link_snapshot() -> dict | None:
    """Codec link-health picture (ops/link.py) — None when the ops
    stack (numpy) is unavailable in this process."""
    try:
        from ..ops import link as link_mod
    except ImportError:
        return None
    return {
        k: (round(v, 6) if isinstance(v, float) else v)
        for k, v in link_mod.snapshot().items()
        if v is not None
    }


def fault_counts() -> dict[str, float]:
    from .. import fault

    return {
        "/".join(str(part) for part in key): v
        for key, v in fault.FAULT_INJECTED.values().items()
    }


class EcAccounting:
    """One volume server's EC-encode ledger: cumulative source bytes
    encoded and PhaseTimer busy-seconds, fed from the `timing`
    summaries the generate RPCs already produce. PER-INSTANCE state —
    in-proc fleets share one process-global metrics registry, so the
    per-server attribution the fleet rate needs cannot live there;
    only the fleet-total counter does. Counters are cumulative (never
    windowed here): the master aggregator computes windowed rates from
    interval deltas so a dead server's contribution ages out."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes = 0  # guarded-by: self._lock
        self._busy_seconds = 0.0  # guarded-by: self._lock
        self._volumes = 0  # guarded-by: self._lock
        self._encodes = 0  # guarded-by: self._lock

    def record(self, timing: dict | None, volumes: int = 1) -> None:
        """Fold one generate RPC's PhaseTimer summary in: source bytes
        from the read phase, busy time from the encode wall clock."""
        if not isinstance(timing, dict):
            return
        read = (timing.get("phases") or {}).get("read") or {}
        nbytes = read.get("bytes") or 0
        busy = timing.get("wall_seconds") or 0.0
        if not isinstance(nbytes, (int, float)) or nbytes < 0:
            nbytes = 0
        if not isinstance(busy, (int, float)) or busy < 0:
            busy = 0.0
        with self._lock:
            self._bytes += int(nbytes)
            self._busy_seconds += float(busy)
            self._volumes += int(volumes)
            self._encodes += 1
        if nbytes:
            from ..stats.metrics import EC_ENCODED_BYTES

            EC_ENCODED_BYTES.inc(amount=float(nbytes))

    def snapshot(self) -> dict | None:
        """The snapshot section, or None while nothing was encoded
        (idle servers ship no ec section at all)."""
        with self._lock:
            if not self._encodes:
                return None
            return {
                "bytes": self._bytes,
                "busy_seconds": round(self._busy_seconds, 6),
                "volumes": self._volumes,
                "encodes": self._encodes,
            }


class ProtocolAccounting:
    """Front-door golden signals per protocol persona (native / s3 /
    fuse / broker): a rolling latency window plus lifetime op/error
    counters, fed by the persona benchmark loads
    (command/benchmark.py). PROCESS-GLOBAL like the metrics registry —
    in-proc fleets all observe the same persona traffic, so the
    aggregator takes the freshest snapshot per protocol instead of
    summing (the same reason fault counters aggregate by max)."""

    NAMES = ("native", "s3", "fuse", "broker")
    PROBE_PREFIX = "proto"
    WINDOW_SECONDS = 30.0
    MAX_SAMPLES = 2048  # per protocol; bounds memory at high ops/s

    def __init__(self):
        self._lock = threading.Lock()
        # protocol -> deque[(mono, seconds, ok)]  # guarded-by: self._lock
        self._samples: dict[str, deque] = {}
        self._ops: dict[str, int] = {}  # guarded-by: self._lock
        self._errors: dict[str, int] = {}  # guarded-by: self._lock

    def lifetime_ops(self, protocol: str) -> float:
        with self._lock:
            return float(self._ops.get(protocol, 0))

    def record(self, protocol: str, seconds: float,
               ok: bool = True) -> None:
        """Fold one persona operation in. Unknown protocol names are
        dropped — the set is a closed enum so neither the snapshot nor
        the flight probes can grow unbounded cardinality."""
        if protocol not in self.NAMES:
            return
        now = time.monotonic()
        register = False
        with self._lock:
            dq = self._samples.get(protocol)
            if dq is None:
                dq = self._samples[protocol] = deque(
                    maxlen=self.MAX_SAMPLES
                )
                register = True
            dq.append((now, float(seconds), bool(ok)))
            self._ops[protocol] = self._ops.get(protocol, 0) + 1
            if not ok:
                self._errors[protocol] = (
                    self._errors.get(protocol, 0) + 1
                )
        if register:
            # first sight of a protocol: give it a flight-recorder
            # ops probe. Registration grabs the recorder's lock, so
            # it must happen OUTSIDE ours (lock-order). Bounded: at
            # most len(NAMES) probes per process, ever.
            from . import recorder as flight

            flight.RECORDER.register_probe(
                f"{self.PROBE_PREFIX}_{protocol}_ops",
                lambda p=protocol: self.lifetime_ops(p),
                kind="counter",
            )

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1,
                int(q * (len(sorted_vals) - 1) + 0.5))
        return sorted_vals[i]

    def section(self) -> dict | None:
        """The snapshot's `protocols` section, or None while no
        persona traffic ever ran (idle servers ship no section).
        Rates and percentiles answer "NOW" (rolling window); op and
        error totals are lifetime."""
        now = time.monotonic()
        horizon = now - self.WINDOW_SECONDS
        with self._lock:
            if not self._samples:
                return None
            out: dict[str, dict] = {}
            for proto, dq in self._samples.items():
                recent = [s for s in dq if s[0] >= horizon]
                lats = sorted(s[1] for s in recent)
                win_errors = sum(1 for s in recent if not s[2])
                if recent:
                    span = max(now - recent[0][0], 1.0)
                    ops_s = len(recent) / span
                    error_rate = win_errors / len(recent)
                else:
                    ops_s = 0.0
                    ops = self._ops.get(proto, 0)
                    error_rate = (
                        self._errors.get(proto, 0) / ops if ops else 0.0
                    )
                out[proto] = {
                    "ops": self._ops.get(proto, 0),
                    "errors": self._errors.get(proto, 0),
                    "ops_s": round(ops_s, 3),
                    "p50_s": round(self._pct(lats, 0.5), 6),
                    "p99_s": round(self._pct(lats, 0.99), 6),
                    "max_s": round(lats[-1], 6) if lats else 0.0,
                    "error_rate": round(error_rate, 6),
                }
            return out


# the process-wide ledger the persona loads feed and every
# collector's snapshot reads
PROTOCOLS = ProtocolAccounting()


class FilerShardAccounting(ProtocolAccounting):
    """Per-shard filer metadata-op golden signals (filer/sharding):
    same rolling-window machinery as the persona ledger, keyed by the
    bounded shard label `shard0..shardN` (never a URL or a path — the
    closed NAMES enum caps cardinality at MAX_SHARDS, matching
    sharding.ring.MAX_SHARDS). Fed by FilerServer._h_object on every
    metadata op; process-global for the same freshest-wins aggregation
    reason as PROTOCOLS."""

    NAMES = tuple(f"shard{i}" for i in range(64))
    PROBE_PREFIX = "filer"


# the process-wide per-shard metadata-op ledger every filer shard in
# this process feeds and every collector's snapshot reads
FILER_SHARDS = FilerShardAccounting()


class TelemetryCollector:
    """Assembles one server role's snapshot; remembers the previous
    request/error totals so every snapshot carries interval deltas
    (the aggregator's SLO burn is computed from deltas, not lifetime
    averages — a 10-minute-old error storm must stop burning once it
    stops). Latency percentiles come from a ROLLING WINDOW of bucket
    deltas for the same reason: p99 must answer "how slow are requests
    NOW", like a prometheus `rate(...[30s])`, not a lifetime average a
    long-lived server can never move."""

    def __init__(self, component: str, url: str = "",
                 window_seconds: float = 30.0):
        self.component = component
        self.url = url
        self.window_seconds = window_seconds
        self._lock = threading.Lock()
        self._prev: dict[str, float] = {}  # guarded-by: self._lock
        # interval arithmetic runs on the monotonic clock
        self._last_mono = time.monotonic()  # guarded-by: self._lock
        # (time, per-bucket delta counts) per collect  # guarded-by: self._lock
        self._bucket_deltas: deque[tuple[float, list[int]]] = deque()
        self._prev_counts: list[int] | None = None  # guarded-by: self._lock
        # EC encode ledger (volume servers feed it; idle elsewhere)
        self.ec = EcAccounting()

    def _windowed_counts(  # weedcheck: holds[self._lock]
        self, now: float, counts: list[int]
    ) -> tuple[list[int], int]:
        """Merge this collect's bucket delta into the rolling window;
        returns (window counts, window total). Caller holds the lock."""
        if self._prev_counts is None:
            # first collect is a BASELINE: the process-lifetime
            # histogram (possibly hours of pre-collector history) must
            # not enter the window as one giant "interval"
            self._prev_counts = list(counts)
            return [0] * len(counts), 0
        delta = [a - b for a, b in zip(counts, self._prev_counts)]
        if any(d < 0 for d in delta):  # registry reset (tests)
            delta = list(counts)
        self._prev_counts = list(counts)
        if any(delta):
            self._bucket_deltas.append((now, delta))
        horizon = now - self.window_seconds
        while self._bucket_deltas and self._bucket_deltas[0][0] < horizon:
            self._bucket_deltas.popleft()
        win = [0] * len(counts)
        for _t, d in self._bucket_deltas:
            win = [a + b for a, b in zip(win, d)]
        return win, sum(win)

    def collect(self) -> dict:
        now = time.time()  # display timestamp on the snapshot
        mono = time.monotonic()
        update_uptime()
        counts, total, sm = merge_histogram(SPAN_SECONDS, self.component)
        # the SLO error rate counts server errors (5xx) only: a 404
        # from a routine existence probe is an answer, not a failure
        by_class = {"4xx": 0.0, "5xx": 0.0}
        for key, v in SPAN_ERRORS.values().items():
            if key and key[0] == self.component and key[1] in by_class:
                by_class[key[1]] += v
        errors = by_class["5xx"]
        with self._lock:
            d_total = total - self._prev.get("requests", 0)
            d_errors = errors - self._prev.get("errors", 0)
            interval = mono - self._last_mono
            self._prev["requests"] = total
            self._prev["errors"] = errors
            self._last_mono = mono
            win_counts, win_total = self._windowed_counts(
                mono, counts
            )
        # percentiles over the rolling window when it has data, over
        # the lifetime histogram otherwise (first scrape, idle server)
        if win_total > 0:
            q_counts, q_total = win_counts, win_total
        else:
            q_counts, q_total = counts, total
        if d_total > 0:
            error_rate = d_errors / d_total
        elif total > 0:
            error_rate = errors / total
        else:
            error_rate = 0.0
        uptime = component_uptimes().get(self.component, 0.0)
        snap = {
            "component": self.component,
            "url": self.url,
            "time": now,
            "interval_seconds": round(interval, 3),
            "uptime_seconds": uptime,
            "process": process_stats(),
            "requests": {
                "total": total,
                "errors": int(errors),
                "errors_4xx": int(by_class["4xx"]),
                "delta": d_total,
                "error_delta": int(d_errors),
                "error_rate": round(error_rate, 6),
                "window_seconds": self.window_seconds,
                "window_total": win_total,
                "p50_seconds": quantile(
                    SPAN_SECONDS.buckets, q_counts, q_total, 0.5
                ),
                "p99_seconds": quantile(
                    SPAN_SECONDS.buckets, q_counts, q_total, 0.99
                ),
                "mean_seconds": round(sm / total, 6) if total else 0.0,
            },
            "codec": link_snapshot(),
            "ec": self.ec.snapshot(),
            "protocols": PROTOCOLS.section(),
            "filer": FILER_SHARDS.section(),
            "breakers": retry_mod.BREAKERS.snapshot(),
            "faults": fault_counts(),
            "slow_worst_seconds": max(
                (e["duration"] for e in slow.LEDGER.entries(limit=1)),
                default=0.0,
            ),
        }
        return snap
