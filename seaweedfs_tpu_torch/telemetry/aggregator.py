"""Master-side cluster telemetry: per-server snapshots → one view.

The master keeps the most recent snapshot per (component, url) —
volume servers deliver theirs inside every heartbeat, filer/S3 push
via `POST /cluster/telemetry`, and the master folds in its own at
read time — and `GET /cluster/telemetry` serves the aggregate:
per-server rows (annotated with age/staleness and per-server degraded
markers) plus a cluster rollup with SLO burn against configurable
objectives (error rate and p99 latency). `weed shell cluster.health`
and `cluster.stats` render this view.

The port's copy of ``seaweedfs_tpu/telemetry/aggregator.py``: the same
views and JSON bodies, with one difference. The p99 objective (a
server's ``p99`` mark and the rollup's ``p99_seconds``) counts only
servers whose rolling window holds requests (``window_total``); the
reference counts any server that ever served one, so a server idle
past its window is judged on its lifetime histogram and stays degraded.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

# a snapshot older than this many seconds marks its server degraded —
# for a volume server that means missed heartbeats, for filer/S3 a
# dead reporter loop; either way the operator should look
_DEFAULT_STALE_AFTER = 15.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class ClusterTelemetry:
    """Snapshot store + aggregation. SLO objectives default from
    SEAWEEDFS_SLO_ERROR_RATE / SEAWEEDFS_SLO_P99_SECONDS and may be
    overridden per read (the shell passes `-errorRate`/`-p99`)."""

    def __init__(
        self,
        slo_error_rate: float | None = None,
        slo_p99_seconds: float | None = None,
        stale_after: float = _DEFAULT_STALE_AFTER,
        evict_after: float | None = None,
        view_cache_ttl: float = 0.0,
    ):
        self.slo_error_rate = (
            slo_error_rate
            if slo_error_rate is not None
            else _env_float("SEAWEEDFS_SLO_ERROR_RATE", 0.01)
        )
        self.slo_p99_seconds = (
            slo_p99_seconds
            if slo_p99_seconds is not None
            else _env_float("SEAWEEDFS_SLO_P99_SECONDS", 2.0)
        )
        self.stale_after = stale_after
        # eviction horizon: a snapshot this old is from a server that
        # is long dead (or a reporter that never unregistered — pushed
        # filer/S3 snapshots have no reaper); dropping it keeps the
        # store O(live servers), not O(ever-seen). Well past the stale
        # threshold so operators see the "stale" marker first.
        self.evict_after = (
            evict_after
            if evict_after is not None
            else max(4 * stale_after, 60.0)
        )
        self._lock = threading.Lock()
        # (component, url) -> latest snapshot  # guarded-by: self._lock
        self._snapshots: dict[tuple[str, str], dict] = {}
        # fleet EC rate window: (mono, cumulative bytes) samples per
        # server, appended at ingest, pruned to the window; the fleet
        # rate is the sum of per-server interval deltas, so a server
        # that stops reporting (dead, stale) stops contributing — the
        # headline is NEVER sticky  # guarded-by: self._lock
        self._ec_samples: dict[
            tuple[str, str], deque[tuple[float, float]]
        ] = {}
        self.ec_window_seconds = max(2 * stale_after, 30.0)
        # rendered-view cache: at fleet scale every converge poller,
        # dashboard, and the flight recorder hits GET /cluster/telemetry
        # concurrently with heartbeat fan-in; re-rendering the full
        # roll-up per read serialized them all on self._lock (the
        # contention profiler measured it as the top site). One render
        # per ttl serves everyone; ttl 0 disables (tests, single reads).
        self.view_cache_ttl = _env_float(
            "SEAWEEDFS_TELEMETRY_CACHE_TTL", view_cache_ttl
        )
        self._view_cache_lock = threading.Lock()
        # (rendered_at_mono, view)  # guarded-by: self._view_cache_lock
        self._view_cache: tuple[float, dict] | None = None

    def ingest(self, snap: dict) -> None:
        """Store one server's snapshot (last write wins per server)."""
        component = str(snap.get("component") or "unknown")
        url = str(snap.get("url") or "")
        entry = dict(snap)
        entry["received_at"] = time.time()
        # ages/staleness are computed on the monotonic clock — the
        # wall-clock received_at above is display metadata only
        entry["_received_mono"] = time.monotonic()
        key = (component, url)
        ec_bytes = ((snap.get("ec") or {}).get("bytes")
                    if isinstance(snap.get("ec"), dict) else None)
        with self._lock:
            self._snapshots[key] = entry
            if isinstance(ec_bytes, (int, float)):
                dq = self._ec_samples.setdefault(key, deque())
                if dq and ec_bytes < dq[-1][1]:
                    # cumulative counter went backwards: the server
                    # restarted — stale pre-restart samples would turn
                    # the reset into a huge negative delta
                    dq.clear()
                dq.append((entry["_received_mono"], float(ec_bytes)))
                horizon = (
                    entry["_received_mono"] - self.ec_window_seconds
                )
                while len(dq) > 1 and dq[0][0] < horizon:
                    dq.popleft()

    def forget(self, url: str) -> None:
        """Drop every snapshot from one server (node unregistered)."""
        with self._lock:
            for key in [k for k in self._snapshots if k[1] == url]:
                self._snapshots.pop(key, None)
            for key in [k for k in self._ec_samples if k[1] == url]:
                self._ec_samples.pop(key, None)

    def evict_stale(self) -> list[tuple[str, str]]:
        """Drop every snapshot past the eviction horizon; returns the
        evicted (component, url) keys. Called on each aggregate read
        and by the master's reaper pulse, so memory stays bounded even
        for pushed reporters (filer/S3) no heartbeat reaper covers."""
        if self.evict_after <= 0:
            return []
        now = time.monotonic()
        with self._lock:
            dead = [
                k
                for k, s in self._snapshots.items()
                if now - s.get("_received_mono", now) > self.evict_after
            ]
            for k in dead:
                self._snapshots.pop(k, None)
                self._ec_samples.pop(k, None)
        return dead

    def age_of(self, url: str) -> float | None:
        """Seconds since the freshest snapshot from `url`, or None when
        the server has never reported (the maintenance scheduler's
        skip-if-degraded check: stale telemetry = do not touch)."""
        now = time.monotonic()
        with self._lock:
            ages = [
                now - s.get("_received_mono", now)
                for (_c, u), s in self._snapshots.items()
                if u == url
            ]
        return min(ages) if ages else None

    def _ec_rate_locked(  # weedcheck: holds[self._lock]
        self, mono_now: float
    ) -> tuple[float, int]:
        """(fleet bytes/s, contributing servers) over the sample
        window. A server whose newest sample is older than
        `stale_after` contributes NOTHING — missed heartbeats must
        never leave its last burst inflating the fleet headline —
        and forget/evict drop its samples entirely."""
        total = 0.0
        reporting = 0
        for dq in self._ec_samples.values():
            if len(dq) < 2:
                continue
            t_last, b_last = dq[-1]
            if mono_now - t_last > self.stale_after:
                continue
            t_first, b_first = dq[0]
            span = t_last - t_first
            if span <= 0 or b_last <= b_first:
                continue
            total += (b_last - b_first) / span
            reporting += 1
        return total, reporting

    def fleet_ec_gbps(self) -> float:
        """Windowed fleet-aggregate EC encode throughput in GB/s —
        the flight-recorder gauge probe and the metrics-family value."""
        now = time.monotonic()
        with self._lock:
            rate, _n = self._ec_rate_locked(now)
        return rate / 1e9

    def _ec_section(self, mono_now: float, own: dict | None) -> dict:
        """The view's fleet-EC rollup: the windowed rate plus lifetime
        totals summed over the currently-stored (live) snapshots."""
        totals = {"bytes": 0, "busy_seconds": 0.0, "volumes": 0,
                  "encodes": 0}
        with self._lock:
            rate, reporting = self._ec_rate_locked(mono_now)
            sections = [
                s.get("ec") for s in self._snapshots.values()
                if isinstance(s.get("ec"), dict)
            ]
        if own is not None and isinstance(own.get("ec"), dict):
            sections.append(own["ec"])
        for ec in sections:
            totals["bytes"] += int(ec.get("bytes") or 0)
            totals["busy_seconds"] += float(
                ec.get("busy_seconds") or 0.0
            )
            totals["volumes"] += int(ec.get("volumes") or 0)
            totals["encodes"] += int(ec.get("encodes") or 0)
        gbps = rate / 1e9
        from ..stats.metrics import FLEET_EC_GBPS

        FLEET_EC_GBPS.set(round(gbps, 9))
        return {
            "fleet_GBps": round(gbps, 6),
            "window_seconds": self.ec_window_seconds,
            "reporting": reporting,
            "bytes_total": totals["bytes"],
            "busy_seconds_total": round(totals["busy_seconds"], 6),
            "volumes_total": totals["volumes"],
            "encodes_total": totals["encodes"],
        }

    def _protocols_section(self, mono_now: float,
                           own: dict | None) -> dict | None:
        """Per-protocol front-door rollup, or None while no persona
        traffic was ever reported. The persona ledger
        (snapshot.PROTOCOLS) is process-global, so every in-proc
        server reports IDENTICAL numbers — the freshest non-stale
        snapshot wins per protocol instead of summing (summing would
        multiply by the server count; the faults-by-max reasoning)."""
        return self._freshest_wins(mono_now, own, "protocols")

    def _filer_section(self, mono_now: float,
                       own: dict | None) -> dict | None:
        """Per-shard filer metadata-op rollup, or None while no filer
        traffic was ever reported. snapshot.FILER_SHARDS is
        process-global exactly like the persona ledger, so the same
        freshest-non-stale-wins merge applies per shard label."""
        return self._freshest_wins(mono_now, own, "filer")

    def _freshest_wins(self, mono_now: float, own: dict | None,
                       section: str) -> dict | None:
        with self._lock:
            rows = [
                (s.get("_received_mono", mono_now),
                 s.get(section))
                for s in self._snapshots.values()
                if isinstance(s.get(section), dict)
            ]
        if own is not None and isinstance(own.get(section), dict):
            rows.append((mono_now, own[section]))
        best: dict[str, tuple[float, dict]] = {}
        for t, protos in rows:
            if mono_now - t > self.stale_after:
                continue
            for name, sec in protos.items():
                if not isinstance(sec, dict):
                    continue
                cur = best.get(name)
                if cur is None or t > cur[0]:
                    best[name] = (t, sec)
        if not best:
            return None
        return {
            name: dict(sec)
            for name, (_t, sec) in sorted(best.items())
        }

    def filer_shards(self) -> list[str]:
        """The ordered filer shard URL list, derived from the shard
        identity every sharded FilerServer rides on its pushed
        snapshot (`filer_shard: {index, of, url}`). Published beside
        /cluster/status so clients re-resolve like MasterRing does for
        leaders. Returns [] unless a COMPLETE, consistent tier is
        known — a partial map would mis-route every path whose shard
        is missing."""
        with self._lock:
            rows = [
                (s.get("_received_mono", 0.0), s.get("filer_shard"))
                for (c, _u), s in self._snapshots.items()
                if c == "filer" and isinstance(
                    s.get("filer_shard"), dict
                )
            ]
        best: dict[int, tuple[float, str, int]] = {}
        for t, fs in rows:
            try:
                idx, of, url = (
                    int(fs["index"]), int(fs["of"]), str(fs["url"])
                )
            except (KeyError, TypeError, ValueError):
                continue
            cur = best.get(idx)
            if cur is None or t > cur[0]:
                best[idx] = (t, url, of)
        if not best:
            return []
        counts = {of for (_t, _u, of) in best.values()}
        if len(counts) != 1:
            return []  # shards disagree on the tier size: unusable
        n = counts.pop()
        if sorted(best) != list(range(n)):
            return []  # incomplete tier
        return [best[i][1] for i in range(n)]

    def _annotate(self, snap: dict, mono_now: float,
                  err_obj: float, p99_obj: float) -> dict:
        s = dict(snap)
        # _received_mono is internal bookkeeping: age on the monotonic
        # clock, then keep it out of the served JSON
        age = mono_now - s.pop("_received_mono", mono_now)
        s["age_seconds"] = round(age, 3)
        degraded: list[str] = []
        if age > self.stale_after:
            degraded.append("stale")
        req = s.get("requests") or {}
        rate = req.get("error_rate")
        if rate is not None and rate > err_obj:
            degraded.append("error-rate")
        # latency is judged on the rolling window only: an idle
        # server's p99 is its lifetime histogram's (snapshot.collect),
        # and a server slow once under load would read degraded for ever
        p99 = req.get("p99_seconds")
        if p99 is not None and req.get("window_total", 0) > 0 \
                and p99 > p99_obj:
            degraded.append("p99")
        # maintenance backlog: queued work older than 3 detector
        # intervals means the plane is not keeping up (dead workers,
        # permanent gate, or an undersized worker pool)
        maint = s.get("maintenance") or {}
        if (
            maint.get("enabled")
            and maint.get("interval", 0) > 0
            and maint.get("backlog_seconds", 0.0)
            > 3 * maint["interval"]
        ):
            degraded.append("maint-backlog")
        s["degraded"] = degraded
        return s

    def view(
        self,
        own: dict | None = None,
        slo_error_rate: float | None = None,
        slo_p99_seconds: float | None = None,
    ) -> dict:
        """The aggregated cluster view; `own` is the master's freshly
        collected snapshot (never stored — it is always current)."""
        self.evict_stale()
        now = time.time()
        mono_now = time.monotonic()
        err_obj = (
            slo_error_rate if slo_error_rate is not None
            else self.slo_error_rate
        )
        p99_obj = (
            slo_p99_seconds if slo_p99_seconds is not None
            else self.slo_p99_seconds
        )
        with self._lock:
            snaps = [dict(s) for s in self._snapshots.values()]
        if own is not None:
            snaps.append(dict(own))
        servers = [
            self._annotate(s, mono_now, err_obj, p99_obj)
            for s in snaps
        ]
        servers.sort(
            key=lambda s: (s.get("component", ""), s.get("url", ""))
        )
        components = sorted(
            {s["component"] for s in servers if s.get("component")}
        )
        total = delta = errors = error_delta = 0
        worst_p99 = 0.0
        faults: dict[str, float] = {}
        breakers_open = 0
        for s in servers:
            req = s.get("requests") or {}
            total += req.get("total", 0)
            delta += req.get("delta", 0)
            errors += req.get("errors", 0)
            error_delta += req.get("error_delta", 0)
            if req.get("window_total", 0) > 0:
                worst_p99 = max(worst_p99, req.get("p99_seconds", 0.0))
            # max, not sum: in-proc clusters share one fault registry,
            # so every server reports the same process-global counters
            # and summing would multiply them by the server count
            for k, v in (s.get("faults") or {}).items():
                faults[k] = max(faults.get(k, 0.0), float(v))
            for b in (s.get("breakers") or {}).values():
                if b.get("state") != "closed":
                    breakers_open += 1
        if delta > 0:
            error_rate = error_delta / delta
        elif total > 0:
            error_rate = errors / total
        else:
            error_rate = 0.0
        slo = {
            "error_rate_objective": err_obj,
            "p99_seconds_objective": p99_obj,
            "error_rate": round(error_rate, 6),
            "error_burn": round(error_rate / err_obj, 3) if err_obj else 0.0,
            "p99_seconds": worst_p99,
            "p99_burn": round(worst_p99 / p99_obj, 3) if p99_obj else 0.0,
        }
        slo["burning"] = slo["error_burn"] > 1.0 or slo["p99_burn"] > 1.0
        healthy = not slo["burning"] and not any(
            s["degraded"] for s in servers
        )
        return {
            "time": now,
            "healthy": healthy,
            "components": components,
            "slo": slo,
            "requests": {
                "total": total,
                "delta": delta,
                "errors": errors,
                "error_delta": error_delta,
            },
            "faults": faults,
            "breakers_open": breakers_open,
            "ec": self._ec_section(mono_now, own),
            "protocols": self._protocols_section(mono_now, own),
            "filer": self._filer_section(mono_now, own),
            "servers": servers,
        }

    def view_cached(
        self,
        own_fn=None,
        slo_error_rate: float | None = None,
        slo_p99_seconds: float | None = None,
    ) -> dict:
        """`view()` behind a per-ttl cache. ``own_fn`` (not a
        snapshot) defers building the master's own row to cache
        misses. Per-read SLO overrides always bypass — a cached view
        rendered against different objectives would answer the wrong
        question. The render itself runs with NO cache lock held:
        concurrent misses may both render, but a render can never
        serialize other readers behind it."""
        if (
            self.view_cache_ttl <= 0
            or slo_error_rate is not None
            or slo_p99_seconds is not None
        ):
            return self.view(
                own=own_fn() if own_fn is not None else None,
                slo_error_rate=slo_error_rate,
                slo_p99_seconds=slo_p99_seconds,
            )
        now = time.monotonic()
        with self._view_cache_lock:
            cached = self._view_cache
        if cached is not None and now - cached[0] < self.view_cache_ttl:
            return cached[1]
        view = self.view(own=own_fn() if own_fn is not None else None)
        with self._view_cache_lock:
            self._view_cache = (now, view)
        return view

    def probe_lock_wait_seconds(self) -> float:
        """Flight-recorder probe: how long ONE bare acquisition of the
        aggregator lock takes right now — a direct read on the
        contention the view cache exists to remove."""
        t0 = time.perf_counter()
        with self._lock:
            pass
        return time.perf_counter() - t0
