"""Message broker: partitioned topics with filer-backed segment logs.

Behavioral model: weed/messaging/broker/ — topics partitioned by a
consistent hash of the message key; per-partition logs persisted under
/topics/<ns>/<topic>/<partition>/ in the filer (the reference stores
segment files the same way); subscribers poll from an offset.

The broker carries the same golden-signal baseline as the other front
doors (master/volume/filer/S3): every request runs under a tracing
span via the shared middleware (which also mounts the `/debug/*`
plane), `/metrics` exposes the registry, publish/subscribe outcomes
count into the bounded `seaweedfs_broker_*` families, and — when
constructed with a `master_url` — a TelemetryReporter pushes the
broker's snapshot so `cluster.health` covers it.

The port's copy of ``seaweedfs_tpu/messaging/broker.py``.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

from .. import fault, tracing
from ..stats.metrics import BROKER_PUBLISH, BROKER_SUBSCRIBE
from ..telemetry.reporter import TelemetryReporter
from ..telemetry.snapshot import mark_started, metrics_response
from ..tracing import middleware as trace_mw
from ..util import http
from ..util import retry as retry_mod
from ..util.http import Request, Response, Router

TOPICS_PREFIX = "/topics"
BROKERS_DIR = "/topics/.system/brokers"


class OffsetRecoveryError(Exception):
    """The persisted offset sequence could not be read (transient
    filer failure / unparseable tail). Minting offset 0 here would name
    the next segment `...000.seg` and CLOBBER the partition's earliest
    persisted segment — silent history loss plus duplicate offsets — so
    the publish must fail instead (the publisher retries)."""


def partition_of(key: bytes, partition_count: int) -> int:
    """Stable key → partition map (xxhash-consistent-hash analog)."""
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "big") % partition_count


def owner_of(
    ns: str, topic: str, partition: int, brokers: list[str]
) -> str:
    """Which live broker owns a topic partition: rendezvous (HRW)
    hashing — deterministic for every observer of the same broker set,
    no coordination, minimal reshuffling when brokers come and go (the
    buraksezer/consistent + xxhash distribution of
    weed/messaging/broker/consistent_distribution.go:20-37)."""
    ident = f"{ns}/{topic}/{partition}".encode()
    return max(
        sorted(brokers),
        key=lambda b: hashlib.blake2b(
            b.encode() + b"\x00" + ident, digest_size=8
        ).digest(),
    )


class MessageBroker:
    def __init__(
        self,
        filer_url: str,
        host: str = "127.0.0.1",
        port: int = 0,
        partition_count: int = 4,
        flush_every: int = 64,
        master_url: str = "",
        telemetry_interval: float = 10.0,
    ):
        """When `master_url` is given the broker pushes its telemetry
        snapshot there periodically (telemetry/reporter.py) so it
        appears in /cluster/telemetry like the filer and S3 gateway."""
        self.filer_url = filer_url
        self.master_url = master_url
        self.telemetry_interval = telemetry_interval
        self._telemetry_reporter: TelemetryReporter | None = None
        self.partition_count = partition_count
        self.flush_every = flush_every
        # backpressure bound: a publish blocks (then 503s) once this
        # many acked-but-unpersisted messages pile up in one
        # partition's tail — the filer falling behind must not grow
        # broker memory or the crash-loss window without limit
        self.max_tail = max(4 * flush_every, 256)
        self.pulse_seconds = 1.0
        # a small tail persists once it is this old rather than every
        # pulse — each coalescing re-POST replaces the segment entry
        # (a garbage needle for vacuum), so trickle topics shouldn't
        # re-POST per second; the crash-loss window is this bound
        self.flush_age_seconds = 3.0
        # (ns, topic, partition) → in-memory tail [(offset, message)]
        self._tails: dict[tuple, list[dict]] = {}  # guarded-by: self._lock
        self._offsets: dict[tuple, int] = {}  # guarded-by: self._lock
        # (ns, topic, partition) → current coalescing segment
        # {"start": offset, "messages": [...], "bytes": n}; written by
        # the single flusher thread OUTSIDE the lock (single-writer-
        # per-partition), read under it — deliberately not guarded-by
        self._open_segs: dict[tuple, dict] = {}
        # batch currently being POSTed by the flusher: swapped out of
        # the tail but not yet visible in a segment — subscribers
        # merge it so reads never see a transient gap
        self._inflight: dict[tuple, list[dict]] = {}  # guarded-by: self._lock
        # when each tail's oldest unpersisted message arrived (drives
        # the age-based flush cadence)
        self._tail_born: dict[tuple, float] = {}  # guarded-by: self._lock
        # ALL filer persistence happens on the flusher thread — the
        # publish path only signals, so it never blocks on filer I/O
        # and segment content stays ordered (single writer)
        self._flush_event = threading.Event()
        self._lock = threading.RLock()
        self._running = False
        router = Router()
        fault.install_routes(router)
        router.add("POST", r"/publish", self._h_publish)
        router.add("GET", r"/subscribe", self._h_subscribe)
        router.add("GET", r"/topics", self._h_topics)
        router.add("GET", r"/cluster", self._h_cluster)
        router.add("GET", r"/metrics", self._h_metrics)
        # the middleware prepends the /debug/* plane and wraps every
        # dispatch in a server span — the broker's requests show up in
        # /debug/traces and the span-latency family like any other role
        self.server = http.HttpServer(
            trace_mw.instrument(router, "broker"), host, port
        )

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        self._running = True
        self.server.start()
        mark_started("broker")
        if self.master_url and self.telemetry_interval > 0:
            self._telemetry_reporter = TelemetryReporter(
                "broker", self.url, self.master_url,
                interval=self.telemetry_interval,
            )
            self._telemetry_reporter.start()
        self._register()
        self._membership = threading.Thread(
            target=self._membership_loop, daemon=True
        )
        self._membership.start()

    def stop(self) -> None:
        self._running = False
        if self._telemetry_reporter is not None:
            self._telemetry_reporter.stop()
        self._flush_event.set()
        t = getattr(self, "_membership", None)
        flusher_done = True
        if t is not None:
            t.join(timeout=2 * self.pulse_seconds)
            if t.is_alive():
                # the flusher may be mid-POST against a slow filer;
                # those batches are acked — wait the POSTs out
                # (bounded by the request timeout) rather than
                # abandon them
                t.join(timeout=65)
            flusher_done = not t.is_alive()
        with self._lock:
            if flusher_done:
                # safe to reclaim in-flight batches: nobody else will
                # POST them
                for key, batch in list(self._inflight.items()):
                    self._tails[key] = (
                        batch + self._tails.get(key, [])
                    )
                self._inflight.clear()
            # else: the abandoned flusher still owns its in-flight
            # batches — re-POSTing them here would race it on the
            # same segment names and could persist the SUBSET last
            todo = {k: v for k, v in self._tails.items() if v}
            for k in todo:
                self._tails[k] = []
        # final persistence OUTSIDE the lock: the POSTs can take a
        # full request timeout against a slow filer, and holding the
        # broker lock that long would stall in-flight publish/
        # subscribe handlers on shutdown (lock-held-across-blocking)
        for k, tail in todo.items():
            if not self._persist_tail(k, tail):
                with self._lock:
                    self._tails[k] = tail + self._tails.get(k, [])
        # deregister so peers stop routing here promptly
        self._reap_dead_broker(self.url)
        self.server.stop()

    # -- membership (broker_server.go KeepConnected-to-filer analog) -----

    def _register(self) -> None:
        # metadata-only entry commit (?entry=true): refreshing
        # liveness every pulse must NOT upload a needle per pulse —
        # a long-lived broker would otherwise generate ~86k garbage
        # needles/day in the backing volume. The broker URL is the
        # entry NAME; no content needed.
        try:
            http.request(
                "POST",
                f"{self.filer_url}{BROKERS_DIR}/"
                f"{self.url.replace(':', '_')}?entry=true",
                json.dumps(
                    {"attr": {"mtime": time.time()}, "chunks": []}
                ).encode(),
                {"Content-Type": "application/json"},
            )
        except http.HttpError:
            pass

    def _membership_loop(self) -> None:
        last_pulse = 0.0
        while self._running:
            # wake early when a tail hits flush_every, else each pulse
            self._flush_event.wait(timeout=self.pulse_seconds)
            self._flush_event.clear()
            if not self._running:
                break
            now = time.monotonic()
            if now - last_pulse >= self.pulse_seconds:
                last_pulse = now
                self._register()  # refresh mtime = liveness
                self._live_cache = self._fetch_live_brokers()  # weedcheck: ignore[unguarded-shared-write]: atomic swap of an immutable cached list; readers tolerate either snapshot
            # bound the acked-but-unpersisted window to one pulse
            # (the reference's LogBuffer flushes on an interval the
            # same way): an abrupt kill loses at most one pulse of
            # tail, not flush_every-1 messages. Tails swap out under
            # the lock; the POSTs happen here, outside it — a slow
            # filer must not stall publish/subscribe.
            with self._lock:
                now2 = time.monotonic()
                todo = {
                    k: v
                    for k, v in self._tails.items()
                    if v
                    and (
                        len(v) >= self.flush_every
                        or now2 - self._tail_born.get(k, 0)
                        >= self.flush_age_seconds
                    )
                }
                for k in todo:
                    self._tails[k] = []
                    self._tail_born.pop(k, None)
                    self._inflight[k] = todo[k]
                # drop counters for partitions that re-homed away:
                # if ownership ever returns here, the next publish
                # must recover the PERSISTED sequence, not resume a
                # stale in-memory one (duplicate offsets = silent
                # message loss at the subscriber's dedup)
                live = self._live_cache or [self.url]
                for k in list(self._offsets):
                    if (
                        k not in todo
                        and not self._tails.get(k)
                        and k not in self._inflight
                        and owner_of(*k, live) != self.url
                    ):
                        self._offsets.pop(k, None)
                        self._open_segs.pop(k, None)
            for k, tail in todo.items():
                ok = self._persist_tail(k, tail)
                with self._lock:
                    self._inflight.pop(k, None)
                    if not ok:
                        self._tails[k] = (
                            tail + self._tails.get(k, [])
                        )

    def live_brokers(self) -> list[str]:
        """Cached live set, refreshed by the membership thread each
        pulse — publish/subscribe must not pay a filer listing per
        message."""
        cached = getattr(self, "_live_cache", None)
        if cached:
            return cached
        out = self._fetch_live_brokers()
        self._live_cache = out  # weedcheck: ignore[unguarded-shared-write]: atomic swap of an immutable cached list; readers tolerate either snapshot
        return out

    def _reap_dead_broker(self, broker_url: str) -> None:
        """Best-effort removal of a dead peer's registration so every
        observer converges off it immediately instead of after its
        mtime ages out (the reference's broker death is seen through
        the broken KeepConnected stream the same way)."""
        try:
            http.request(
                "DELETE",
                f"{self.filer_url}{BROKERS_DIR}/"
                f"{broker_url.replace(':', '_')}",
            )
        except http.HttpError:
            pass

    def _fetch_live_brokers(self) -> list[str]:
        """Brokers whose registration is fresh (mtime within 3 pulses);
        always includes self so a lone broker owns everything."""
        brokers = {self.url}
        try:
            listing = http.get_json(
                f"{self.filer_url}{BROKERS_DIR}/?limit=1000"
            )
            now = time.time()
            for e in listing.get("Entries") or []:
                if e.get("IsDirectory"):
                    continue
                # Mtime is the FILER's wall epoch: cross-process
                if now - e.get("Mtime", 0) <= 3 * self.pulse_seconds:  # weedcheck: ignore[wall-clock-duration]
                    brokers.add(
                        e["FullPath"].rsplit("/", 1)[-1].replace(
                            "_", ":"
                        )
                    )
        except http.HttpError:
            pass
        return sorted(brokers)

    def _h_cluster(self, req: Request) -> Response:
        tracing.set_op("broker.cluster")
        brokers = self.live_brokers()
        return Response.json({"self": self.url, "brokers": brokers})

    def _h_metrics(self, req: Request) -> Response:
        return metrics_response()

    # -- persistence -----------------------------------------------------

    def _segment_dir(self, ns: str, topic: str, partition: int) -> str:
        return f"{TOPICS_PREFIX}/{ns}/{topic}/{partition:02d}"

    # a segment accepts appended flushes (re-POST of the same name
    # with the combined content) until it reaches this size — without
    # coalescing, per-pulse flushing of a slow topic would mint one
    # tiny segment file per second forever
    SEGMENT_TARGET_BYTES = 256 * 1024

    def _persist_tail(self, key: tuple, tail: list[dict]) -> bool:
        """Persist messages to the filer, coalescing into the current
        segment until it reaches SEGMENT_TARGET_BYTES. Thread-safe
        per key under the single-writer-per-partition model; does NOT
        require the broker lock (no shared-tail access)."""
        ns, topic, partition = key
        cur = self._open_segs.get(key)
        if cur is not None and cur["bytes"] < self.SEGMENT_TARGET_BYTES:
            start = cur["start"]
            msgs = cur["messages"] + tail
        else:
            start = tail[0]["offset"]
            msgs = list(tail)
        seg = (
            f"{self._segment_dir(ns, topic, partition)}/"
            f"{start:020d}.seg"
        )
        body = "\n".join(json.dumps(m) for m in msgs).encode()
        try:
            # idempotent (same segment path, same content): retriable
            # through the shared policy before deferring to next flush
            http.request(
                "POST", f"{self.filer_url}{seg}", body,
                retry=retry_mod.UPLOAD,
            )
        except http.HttpError:
            return False
        self._open_segs[key] = {
            "start": start,
            "messages": msgs,
            "bytes": len(body),
        }
        return True

    def _list_segments(self, seg_dir: str) -> list[str]:
        """ALL segment paths, ascending — paginated so partitions with
        more segments than one listing page still recover the true
        tail (a truncated listing would silently reuse old offsets).

        A 404 is a CONFIRMED-absent directory (the filer answered: no
        such path) → []. Any other failure is indistinguishable from
        "segments exist but the filer is struggling" and raises
        OffsetRecoveryError — callers must not treat it as empty."""
        try:
            entries = http.list_filer_dir(
                self.filer_url, seg_dir, retry=retry_mod.LOOKUP
            )
        except http.HttpError as e:
            if e.status == 404:
                return []
            raise OffsetRecoveryError(
                f"listing {seg_dir} failed: {e}"
            ) from e
        return sorted(
            e["FullPath"]
            for e in entries
            if e["FullPath"].endswith(".seg")
        )

    def _recover_next_offset(self, pkey: tuple) -> int:
        """Next offset for a partition this broker has no memory of:
        read the tail of the persisted segment log (the new owner of a
        moved partition continues the sequence).

        Returns 0 ONLY when the segment directory is confirmed absent
        or empty; a transient listing/read/parse failure raises
        OffsetRecoveryError so the publish 503s instead of restarting
        the sequence at 0 and clobbering segment `...000.seg`."""
        ns, topic, partition = pkey
        segs = self._list_segments(
            self._segment_dir(ns, topic, partition)
        )
        if not segs:
            return 0
        try:
            data = http.request("GET", f"{self.filer_url}{segs[-1]}")
            last = json.loads(data.splitlines()[-1])
            return int(last["offset"]) + 1
        except (http.HttpError, ValueError, IndexError, KeyError) as e:
            raise OffsetRecoveryError(
                f"reading segment tail {segs[-1]} failed: {e}"
            ) from e

    # -- handlers --------------------------------------------------------

    def _h_publish(self, req: Request) -> Response:
        tracing.set_op("broker.publish")
        body = req.json()
        ns = body.get("namespace", "default")
        topic = body["topic"]
        key = body.get("key", "")
        partition = partition_of(key.encode(), self.partition_count)
        # partition ownership is spread across live brokers; a publish
        # landing on the wrong one proxies to the owner (`direct=1`
        # skips re-routing so transient membership disagreement can't
        # loop)
        if req.param("direct") != "1":
            brokers = self.live_brokers()
            dead: set[str] = set()
            while True:
                owner = owner_of(ns, topic, partition, brokers)
                if owner == self.url:
                    break  # fall through to the local accept path
                try:
                    out = http.request(
                        "POST",
                        f"{owner}/publish?direct=1",
                        req.body,
                        {"Content-Type": "application/json"},
                        timeout=30,
                    )
                    BROKER_PUBLISH.inc("proxied")
                    return Response(
                        status=200, body=out,
                        headers={"Content-Type": "application/json"},
                    )
                except http.HttpError as e:
                    if not e.connection_refused:
                        # timeout / reset / 5xx: the owner may be
                        # alive and may have ALREADY appended this
                        # message — accepting it elsewhere would fork
                        # the partition's single-writer offset
                        # sequence and duplicate offsets. Refuse; the
                        # publisher retries.
                        BROKER_PUBLISH.inc("rejected")
                        return Response.error(
                            f"partition owner {owner} "
                            f"unreachable: {e}",
                            503,
                        )
                    # connection REFUSED: the owner's listener is
                    # gone and it never saw the request. Re-resolve
                    # membership NOW (not at the next pulse tick),
                    # reap the corpse, and retry with the next HRW
                    # owner — the failover window closes in one
                    # round-trip, with no duplication risk. The loop
                    # terminates because self is always in the live
                    # set and each retry removes one corpse.
                    dead.add(owner)
                    self._reap_dead_broker(owner)
                    brokers = [
                        b
                        for b in self._fetch_live_brokers()
                        if b not in dead
                    ]
                    self._live_cache = brokers  # weedcheck: ignore[unguarded-shared-write]: atomic swap of an immutable cached list; readers tolerate either snapshot
        pkey = (ns, topic, partition)
        # backpressure: block (bounded) while this partition's tail is
        # at the cap, then refuse — never ack into unbounded memory
        deadline = time.monotonic() + 5.0
        while True:
            with self._lock:
                if len(self._tails.get(pkey) or []) < self.max_tail:
                    break
            self._flush_event.set()
            if time.monotonic() >= deadline:
                BROKER_PUBLISH.inc("rejected")
                return Response.error(
                    "persistence backlog: tail at capacity", 503
                )
            time.sleep(0.05)
        # Ownership may have just moved here (join/leave): continue
        # the PERSISTED sequence, never restart at 0. Recovery reads
        # the filer, so it must run OUTSIDE the broker lock — one slow
        # filer listing would otherwise stall every publish/subscribe
        # on this broker (weedcheck lock-held-across-blocking). The
        # recovered value installs via setdefault (racing recoverers
        # compute the same persisted tail), and the append re-checks
        # under the lock because the membership loop may drop a
        # re-homed partition's counter in the window between.
        for _attempt in range(2):
            with self._lock:
                if pkey in self._offsets:
                    offset = self._offsets[pkey]
                    msg = {
                        "offset": offset,
                        "ts_ns": time.time_ns(),
                        "key": key,
                        "value": body.get("value", ""),
                        "headers": body.get("headers", {}),
                    }
                    if not self._tails.get(pkey):
                        self._tail_born[pkey] = time.monotonic()
                    self._tails.setdefault(pkey, []).append(msg)
                    self._offsets[pkey] = offset + 1
                    if len(self._tails[pkey]) >= self.flush_every:
                        # wake the flusher; persistence stays off
                        # this path
                        self._flush_event.set()
                    BROKER_PUBLISH.inc("accepted")
                    return Response.json(
                        {"partition": partition, "offset": offset}
                    )
            try:
                recovered = self._recover_next_offset(pkey)
            except OffsetRecoveryError as e:
                # refuse rather than mint offset 0 over persisted
                # history; the publisher retries after the filer
                # recovers
                BROKER_PUBLISH.inc("rejected")
                return Response.error(
                    f"offset recovery failed: {e}", 503
                )
            with self._lock:
                self._offsets.setdefault(pkey, recovered)
        BROKER_PUBLISH.inc("rejected")
        return Response.error(
            "partition ownership unstable during offset recovery", 503
        )

    def _h_subscribe(self, req: Request) -> Response:
        tracing.set_op("broker.subscribe")
        ns = req.param("namespace", "default")
        topic = req.param("topic")
        partition = int(req.param("partition", "0"))
        since = int(req.param("offset", "0"))
        limit = int(req.param("limit", "100"))
        if req.param("direct") != "1":
            owner = owner_of(
                ns, topic, partition, self.live_brokers()
            )
            if owner != self.url:
                try:
                    import urllib.parse as up

                    qs = up.urlencode(
                        {
                            "direct": "1",
                            "namespace": ns,
                            "topic": topic,
                            "partition": partition,
                            "offset": since,
                            "limit": limit,
                        }
                    )
                    out = http.request(
                        "GET", f"{owner}/subscribe?{qs}", timeout=30,
                    )
                    BROKER_SUBSCRIBE.inc("proxied")
                    return Response(
                        status=200, body=out,
                        headers={"Content-Type": "application/json"},
                    )
                except http.HttpError:
                    pass  # serve from segments locally
        pkey = (ns, topic, partition)
        messages: list[dict] = []
        seen: set[int] = set()

        def take(m: dict) -> None:
            if (
                m["offset"] >= since
                and m["offset"] not in seen
                and len(messages) < limit
            ):
                seen.add(m["offset"])
                messages.append(m)

        # replay persisted segments, then overlay the flusher's
        # in-flight batch and the in-memory tail — offset dedup makes
        # the overlap between a coalesced segment and the pending
        # sets harmless, and readers never see the swap-to-POST gap.
        # A transient listing failure degrades to memory-only reads
        # (subscribers poll again); unlike publish, nothing is minted.
        try:
            segs = self._list_segments(
                self._segment_dir(ns, topic, partition)
            )
        except OffsetRecoveryError:
            segs = []
        # zero-padded names encode start offsets: of the segments
        # starting at/below `since`, only the LAST can contain it —
        # a tailing subscriber skips the whole history
        starts = [
            int(s.rsplit("/", 1)[-1].split(".")[0]) for s in segs
        ]
        first = 0
        for i, st in enumerate(starts):
            if st <= since:
                first = i
        for seg in segs[first:]:
            try:
                data = http.request("GET", f"{self.filer_url}{seg}")
            except http.HttpError:
                continue
            for line in data.splitlines():
                take(json.loads(line))
        with self._lock:
            # the open (still-coalescing) segment's content lives in
            # memory too: a coalesce re-POST briefly replaces the
            # segment entry under a concurrent reader, and this
            # overlay bridges that window
            open_seg = self._open_segs.get(pkey)
            pending = (
                list(open_seg["messages"] if open_seg else [])
                + list(self._inflight.get(pkey) or [])
                + list(self._tails.get(pkey) or [])
            )
        for m in pending:
            take(m)
        messages.sort(key=lambda m: m["offset"])
        BROKER_SUBSCRIBE.inc("served")
        return Response.json(
            {
                "messages": messages,
                "next_offset": (
                    messages[-1]["offset"] + 1 if messages else since
                ),
            }
        )

    def _h_topics(self, req: Request) -> Response:
        tracing.set_op("broker.topics")
        try:
            listing = http.get_json(
                f"{self.filer_url}{TOPICS_PREFIX}/"
                f"{req.param('namespace', 'default')}/?limit=1000"
            )
            topics = [
                e["FullPath"].rsplit("/", 1)[-1]
                for e in listing.get("Entries") or []
                if e["IsDirectory"]
            ]
        except http.HttpError:
            topics = []
        with self._lock:
            for ns, topic, _ in self._tails:
                if topic not in topics:
                    topics.append(topic)
        return Response.json({"topics": sorted(topics)})
