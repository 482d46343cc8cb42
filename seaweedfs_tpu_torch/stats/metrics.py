"""Prometheus-exposition-format metrics registry of the port.

The port's copy of ``seaweedfs_tpu/stats/metrics.py`` (SeaweedFS
weed/stats/metrics.go:19-123): counters, gauges and exponential-bucket
histograms, exposed as text/plain in the same format, so a family keeps
its name and its dashboards whichever package fed it. :data:`REGISTRY`
is the port's own: the modules that define families (``ops/link.py``,
``ops/profiler.py``, ``telemetry/devices.py``, ``telemetry/phases.py``,
``tracing/recorder.py``, ``fault``, ``maintenance/scheduler.py``)
register them here, and the volume server's three families, the
filer's two, the S3 gateway's, the fleet EC pair, the client master
ring's, the sharded filer ring's and the broker's are defined below.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict


class Counter:
    def __init__(self, name: str, help_text: str = "",
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = defaultdict(  # guarded-by: self._lock
            float
        )

    def inc(self, *label_values, amount: float = 1.0) -> None:
        with self._lock:
            self._values[tuple(label_values)] += amount

    def values(self) -> dict[tuple, float]:
        """Consistent snapshot of every label set's current total."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        for labels, v in sorted(self.values().items()):
            out.append(f"{self.name}{_fmt(self.label_names, labels)} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_text: str = "",
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}  # guarded-by: self._lock

    def set(self, value: float, *label_values) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value

    def values(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for labels, v in sorted(self.values().items()):
            out.append(f"{self.name}{_fmt(self.label_names, labels)} {v}")
        return out


class Histogram:
    """Exponential buckets, like the reference's request histograms
    (metrics.go: ExponentialBuckets(0.0001, 2, 24))."""

    def __init__(self, name: str, help_text: str = "",
                 labels: tuple[str, ...] = (),
                 start: float = 0.0001, factor: float = 2.0,
                 count: int = 24):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self.buckets = [start * factor**i for i in range(count)]
        self._lock = threading.Lock()
        # per-bucket (non-cumulative) counts, running sums, and totals
        # all move together under the one lock; expose() snapshots them
        # under the same lock so a concurrent observe can never yield a
        # +Inf bucket that disagrees with _count/_sum
        self._counts: dict[tuple, list[int]] = {}  # guarded-by: self._lock
        self._sums: dict[tuple, float] = defaultdict(  # guarded-by: self._lock
            float
        )
        self._totals: dict[tuple, int] = defaultdict(  # guarded-by: self._lock
            int
        )

    def observe(self, value: float, *label_values) -> None:
        # hot path (every request): one bisect into the sorted bucket
        # bounds and ONE increment — the non-cumulative per-bucket
        # counts are summed into prometheus cumulative form at expose
        # time instead of paying a 24-bucket scan per observation
        key = tuple(label_values)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * len(self.buckets)
            )
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):  # above the last bound: only +Inf
                counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def time(self, *label_values):
        h = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                h.observe(
                    time.perf_counter() - self.t0, *label_values
                )

        return _Timer()

    def merge_counts(self, bucket_counts: list[int], total: int,
                     sum_: float, *label_values) -> None:
        """Fold externally aggregated per-bucket DELTAS into one label
        set. The lock-contention profiler counts waits in its own
        per-site buckets (same exponential shape) and periodically
        merges the delta here, so the hot acquire path never touches
        this family's shared lock."""
        key = tuple(label_values)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * len(self.buckets)
            )
            for i, c in enumerate(bucket_counts[:len(counts)]):
                if c:
                    counts[i] += c
            self._sums[key] += sum_
            self._totals[key] += total

    def snapshot(self) -> dict[tuple, tuple[list[int], int, float]]:
        """Label set -> (per-bucket counts, total count, sum), taken
        atomically — the consumer (exposition, telemetry percentiles)
        sees every observation in all three or in none."""
        with self._lock:
            return {
                key: (list(counts), self._totals[key], self._sums[key])
                for key, counts in self._counts.items()
            }

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for key, (counts, total, sm) in sorted(self.snapshot().items()):
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt(self.label_names + ('le',), key + (b,))}"
                    f" {cum}"
                )
            # the cumulative +Inf bucket: always emitted, always equal
            # to _count (the lock-consistent snapshot guarantees it
            # even while observes race this scrape)
            out.append(
                f"{self.name}_bucket"
                f"{_fmt(self.label_names + ('le',), key + ('+Inf',))}"
                f" {total}"
            )
            out.append(
                f"{self.name}_sum{_fmt(self.label_names, key)}"
                f" {sm}"
            )
            out.append(
                f"{self.name}_count{_fmt(self.label_names, key)}"
                f" {total}"
            )
        return out


def _escape(value) -> str:
    """Escape a label value per the Prometheus exposition format
    (backslash first, then quote and newline)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    pairs = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + pairs + "}"


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                # double-exposing one family corrupts every scrape
                # (prometheus rejects duplicate series); fail loudly at
                # registration instead
                raise ValueError(
                    f"metric {metric.name!r} already registered"
                )
            self._metrics.append(metric)
        return metric

    def counter(self, name, help_text="", labels=()):
        return self.register(Counter(name, help_text, labels))

    def gauge(self, name, help_text="", labels=()):
        return self.register(Gauge(name, help_text, labels))

    def histogram(self, name, help_text="", labels=(),
                  start=0.0001, factor=2.0, count=24):
        return self.register(
            Histogram(name, help_text, labels, start, factor, count)
        )

    def families(self) -> list:
        """Copy of the registered families (the flight recorder walks
        them to probe every counter/gauge without holding this lock
        during the probes)."""
        with self._lock:
            return list(self._metrics)

    def expose(self) -> str:
        lines: list[str] = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# the reference's volume-server, filer and s3 families
# (weed/stats/metrics.go:19-123)
VOLUME_SERVER_REQUESTS = REGISTRY.counter(
    "SeaweedFS_volumeServer_request_total",
    "Counter of volume server requests.",
    ("type",),
)
VOLUME_SERVER_LATENCY = REGISTRY.histogram(
    "SeaweedFS_volumeServer_request_seconds",
    "Bucketed histogram of volume server request latency.",
    ("type",),
)
VOLUME_SERVER_VOLUME_COUNT = REGISTRY.gauge(
    "SeaweedFS_volumeServer_volumes",
    "Number of volumes or EC shards.",
    ("collection", "type"),
)
FILER_REQUESTS = REGISTRY.counter(
    "SeaweedFS_filer_request_total",
    "Counter of filer requests.",
    ("type",),
)
FILER_LATENCY = REGISTRY.histogram(
    "SeaweedFS_filer_request_seconds",
    "Bucketed histogram of filer request latency.",
    ("type",),
)
S3_REQUESTS = REGISTRY.counter(
    "SeaweedFS_s3_request_total",
    "Counter of s3 requests.",
    ("type",),
)

# fleet EC observatory families (bounded: zero labels). The counter is
# process-global — in-proc clusters sum every server's encodes into
# it, which is exactly the fleet total the flight recorder's registry
# sweep turns into an m.* rate; per-server attribution lives in the
# telemetry snapshots, not in a per-url label (unbounded at fleet
# scale). The gauge mirrors the master aggregator's windowed rate.
EC_ENCODED_BYTES = REGISTRY.counter(
    "seaweedfs_ec_encoded_bytes_total",
    "Source bytes EC-encoded by volume servers in this process.",
)
FLEET_EC_GBPS = REGISTRY.gauge(
    "seaweedfs_fleet_ec_GBps",
    "Windowed fleet-aggregate EC encode throughput (GB/s), as "
    "computed by the master telemetry aggregator.",
)

# failover arc families: leader re-resolution in the client master
# ring (operation/masters.py). The `master` label is the candidate's
# SLOT INDEX in the ring — cardinality is bounded by the spec'd master
# count (a hint pointing outside the configured ring collapses to the
# single "external" slot), never by the URL space. `reason` is one of
# {hint, status, rotate}: a not-leader body hint, a /cluster/status
# re-resolution, or a blind next-candidate rotation on a dead peer.
MASTER_RING_ROTATIONS = REGISTRY.counter(
    "seaweedfs_master_ring_rotations_total",
    "Client master-ring leader changes by ring slot and reason.",
    ("master", "reason"),
)
MASTER_LEADER_RESOLVES = REGISTRY.counter(
    "seaweedfs_master_leader_resolves_total",
    "Full /cluster/status leader sweeps by outcome "
    "(found | no_leader).",
    ("outcome",),
)

# sharded filer plane families (filer/sharding/ring.py). Both label
# sets are closed enums — never a shard URL or a path: `outcome` for
# resolves is {refreshed, unchanged, unavailable, count_mismatch,
# no_masters}; for cross-shard renames it is {completed, interrupted,
# recovered}. Per-shard rates live in the telemetry snapshot's
# bounded shard0..shardN section, not in a metric label here.
FILER_RING_RESOLVES = REGISTRY.counter(
    "seaweedfs_filer_ring_resolves_total",
    "Client filer-ring shard-map re-resolutions by outcome.",
    ("outcome",),
)
FILER_CROSS_RENAMES = REGISTRY.counter(
    "seaweedfs_filer_cross_shard_renames_total",
    "Cross-shard filer renames by outcome "
    "(completed | interrupted | recovered).",
    ("outcome",),
)

# broker front-door families (observability arc): the broker predates
# the golden-signal baseline, so its publish/subscribe paths gain
# bounded-outcome counters. `outcome` is a closed enum, never a topic
# or partition (topics are user-controlled = unbounded cardinality):
# publish: accepted (appended locally) | proxied (forwarded to the
# HRW owner) | rejected (backpressure / offset-recovery failure /
# unreachable owner — all 503s); subscribe: served (answered from
# local segments+tail) | proxied (forwarded to the owner).
BROKER_PUBLISH = REGISTRY.counter(
    "seaweedfs_broker_publish_total",
    "Broker publish requests by outcome "
    "(accepted | proxied | rejected).",
    ("outcome",),
)
BROKER_SUBSCRIBE = REGISTRY.counter(
    "seaweedfs_broker_subscribe_total",
    "Broker subscribe requests by outcome (served | proxied).",
    ("outcome",),
)
