"""Convergence checker: poll until the cluster heals itself.

After churn stops, the cluster must return to a healthy
`cluster.health` verdict with ZERO operator input: the master reaps
dead nodes, the repair loop re-replicates degraded writes, the
maintenance plane rebuilds EC shards and drains its queue, and the
telemetry aggregator's view goes green. This module polls
`/cluster/telemetry` (the same view the shell renders) and reports
time-to-converge plus the reasons for every unhealthy poll — a round
that never converges tells you exactly what stayed broken.

The port's copy of ``seaweedfs_tpu/scale/converge.py``, polling the port's
master through the port's client.
"""

from __future__ import annotations

import time

from ..operation.masters import ring_of
from ..util import http
from ..util import retry as retry_mod


def _netloc(url: str) -> str:
    return url.split("://", 1)[-1].rstrip("/")


def check_view(view: dict, live_urls: set[str] | None = None,
               expect_volume_servers: int | None = None) -> list[str]:
    """Reasons this telemetry view is NOT converged (empty = healthy).

    `live_urls` scopes the breaker gate: a breaker toward a
    permanently-dead server stays open forever by design (no traffic
    means no half-open probe), so only open breakers toward servers
    the caller believes ALIVE block convergence."""
    reasons: list[str] = []
    slo = view.get("slo") or {}
    if slo.get("burning"):
        reasons.append(
            f"slo-burn error={slo.get('error_burn')} "
            f"p99={slo.get('p99_burn')}"
        )
    live = (
        {_netloc(u) for u in live_urls}
        if live_urls is not None else None
    )
    volume_rows = 0
    open_toward_live: set[str] = set()
    for s in view.get("servers", ()):
        if s.get("component") == "volume":
            volume_rows += 1
        for mark in s.get("degraded", ()):
            reasons.append(
                f"degraded {s.get('component')}@{s.get('url')}: {mark}"
            )
        for peer, b in (s.get("breakers") or {}).items():
            if b.get("state") == "closed":
                continue
            if live is None or _netloc(peer) in live:
                open_toward_live.add(peer)
        maint = s.get("maintenance")
        if maint:
            depth = maint.get("queued", 0) + maint.get("running", 0)
            if depth:
                reasons.append(f"maint-queue depth={depth}")
        repair = s.get("repair_backlog")
        if repair and repair.get("fids"):
            reasons.append(
                f"repair-backlog fids={repair['fids']} "
                f"reporters={repair['reporters']}"
            )
    for peer in sorted(open_toward_live):
        reasons.append(f"breaker-open toward live {peer}")
    if (
        expect_volume_servers is not None
        and volume_rows != expect_volume_servers
    ):
        reasons.append(
            f"volume-servers reported={volume_rows} "
            f"expected={expect_volume_servers}"
        )
    return reasons


def wait_for_convergence(
    master_url,
    live_urls=None,
    expect_volume_servers=None,
    timeout: float = 120.0,
    poll_interval: float = 0.5,
    stable_polls: int = 3,
) -> dict:
    """Poll `/cluster/telemetry` until `stable_polls` CONSECUTIVE
    healthy reads (one green poll can be a lull between a kill landing
    and its heartbeat timing out). `live_urls` /
    `expect_volume_servers` may be zero-arg callables so the caller's
    view of the fleet tracks late revivals.

    `master_url` may be one URL, the full master-tier URL list, or a
    `MasterRing`. With a multi-master ring every poll re-resolves the
    leader first: followers serve `/cluster/telemetry` too, but their
    views are SPARSE (heartbeats only flow to the leader), so a poller
    pinned to a follower after a leader kill would sit on
    "volume-servers reported=0" forever and call it non-convergence.

    Returns {"converged", "seconds", "polls", "last_reasons",
    "poll_ms"}; `seconds` is monotonic time from call to the FIRST
    poll of the stable healthy streak — the cluster was healed then,
    the confirmation polls are the checker's cost, not the cluster's.
    `poll_ms` has one aggregator read latency per poll (the view is
    assembled under the telemetry lock — its read latency IS the
    aggregator latency a scale round records)."""
    ring = ring_of(master_url)
    t0 = time.monotonic()
    polls = 0
    healthy_streak = 0
    first_healthy: float | None = None
    last_reasons: list[str] = ["never polled"]
    poll_ms: list[float] = []
    while time.monotonic() - t0 < timeout:
        polls += 1
        if len(ring) > 1:
            # a follower's Leader field can point at the DEAD master
            # until its own election timer fires, so resolve() may
            # come back None or stale mid-election — the outer loop
            # absorbs that as an unhealthy poll and tries again
            url = ring.resolve() or ring.leader()
        else:
            url = ring.leader()
        t_poll = time.perf_counter()
        try:
            view = http.get_json(
                f"{url}/cluster/telemetry",
                retry=retry_mod.LOOKUP,
            )
        except (http.HttpError, OSError) as e:
            last_reasons = [f"telemetry unreachable via {url}: {e}"]
            healthy_streak = 0
            first_healthy = None
            time.sleep(poll_interval)
            continue
        poll_ms.append((time.perf_counter() - t_poll) * 1000)
        lu = live_urls() if callable(live_urls) else live_urls
        ev = (
            expect_volume_servers()
            if callable(expect_volume_servers)
            else expect_volume_servers
        )
        reasons = check_view(
            view, live_urls=lu, expect_volume_servers=ev
        )
        if not view.get("healthy") and not reasons:
            # the aggregate verdict saw something check_view didn't —
            # never report converged against a red verdict
            reasons = ["view.healthy is false"]
        if reasons:
            last_reasons = reasons
            healthy_streak = 0
            first_healthy = None
        else:
            if healthy_streak == 0:
                first_healthy = time.monotonic()
            healthy_streak += 1
            if healthy_streak >= stable_polls:
                return {
                    "converged": True,
                    "seconds": round(first_healthy - t0, 3),
                    "polls": polls,
                    "last_reasons": [],
                    "poll_ms": poll_ms,
                }
        time.sleep(poll_interval)
    return {
        "converged": False,
        "seconds": round(time.monotonic() - t0, 3),
        "polls": polls,
        "last_reasons": last_reasons,
        "poll_ms": poll_ms,
    }
