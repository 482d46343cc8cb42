"""Load benchmark: a seeded workload generator against a live cluster.

Behavioral model: weed/command/benchmark.go:111-196 (N files at a
concurrency level, throughput + latency percentile report), grown into
the request-path analog of bench.py's codec trajectory:

* **mixed op workloads** — ``-mix "write:30,read:60,delete:10"`` runs
  one steady phase drawing ops from the weighted mix (the classic
  write-then-read two-phase run remains the default);
* **zipfian key popularity** — reads/deletes sample the written keys
  rank-weighted (``1/rank^s``, ``-zipf s``), the haystack access
  pattern small-object stores live and die by;
* **variable object sizes** — ``-sizes 512-4096`` draws each write's
  size uniformly; reads verify against the write log's recorded size,
  not a single global constant;
* **warmup + steady-state duration** — ``-warmup N`` ops are executed
  but not recorded; ``-duration S`` replaces the fixed op count with a
  wall-clock window;
* **failure accounting** — an op that raises is a per-phase FAILURE
  with its error class sampled, never a 0 ms latency (which skewed
  every percentile down); percentiles are over successes only;
* **reproducibility** — one ``-seed`` feeds every RNG (payload bytes,
  sizes, op choice, key sampling);
* **multi-protocol personas** — ``-personas
  native:40,s3:30,fuse:20,broker:10`` runs concurrent seeded
  workloads against every front door of ONE fleet: S3 multipart PUT /
  ranged GET / list through the gateway, FUSE-style file churn via
  the WFS API (no kernel mount), broker pub/sub with offset-recovery
  reads. Each persona gets its weight's share of the worker pool,
  per-protocol latency histograms and failure counts, and a
  ``detail.protocols.{name}.{ops_s,p50_s,p99_s,error_rate}`` section
  that benchgate gates direction-aware; the same ops feed the live
  telemetry ledger (``telemetry.snapshot.PROTOCOLS``) so
  ``cluster.health`` and the flight recorder see them;
* **recorded rounds** — ``--json LOAD_rNN.json`` writes the result in
  the BENCH_*.json trajectory shape and ``--check LOAD_rNN.json``
  gates this run against a stored round (ops/s drops and p99/failure
  rises past the threshold exit 1) via the shared
  ``util/benchgate.py`` the codec bench also uses. The summary is
  also pushed to the master (``POST /cluster/benchmark``) so
  ``cluster.health`` shows load numbers next to SLO burn.

The port's copy of ``seaweedfs_tpu/command/benchmark.py``, on the port's
client, master ring, persona ledger and benchgate. All four personas
run: ``native``, ``s3`` through the port's S3 gateway, ``fuse`` through
its ``WFS`` and ``broker`` through its message broker.
"""

from __future__ import annotations

import bisect
import json
import os
import random
import threading
import time

import numpy as np

from .. import operation
from ..operation.masters import MasterRing
from ..telemetry.snapshot import PROTOCOLS
from ..util import benchgate
from ..util import http
from ..util import retry as retry_mod

# ops whose latency/failures are tracked separately
OPS = ("write", "read", "delete")

# the front-door personas a mixed-protocol run can drive concurrently
# (``-personas native:40,s3:30,fuse:20,broker:10``), each with its own
# op mix over its protocol's verbs
PERSONAS = ("native", "s3", "fuse", "broker")

PERSONA_MIXES: dict[str, dict[str, float]] = {
    "native": {"write": 0.5, "read": 0.4, "delete": 0.1},
    "s3": {"put": 0.45, "get": 0.45, "list": 0.1},
    "fuse": {"create": 0.45, "read": 0.4, "unlink": 0.15},
    "broker": {"publish": 0.65, "subscribe": 0.35},
}

# the most recent run's round record (run_benchmark sets it):
# programmatic drivers (scale/round.py) read the summary here instead
# of re-parsing the JSON file or capturing `out` lines
LAST_RESULT: dict | None = None

# per-op completion trace of the most recent run, when requested with
# ``op_trace=True``: (monotonic_s, op, ok) per recorded attempt, time
# sorted. scale/round.py intersects it with the leader-election window
# to compute detail.midfailover_failure_rate
LAST_OP_TRACE: list[tuple[float, str, bool]] | None = None

# per-persona op traces of the most recent persona run (op_trace=True):
# persona name -> [(monotonic_s, op, ok), ...] — the determinism tests
# compare op-name sequences across same-seed reruns
LAST_PERSONA_TRACES: dict[str, list] | None = None

_HIST_EDGES_MS = [0.25 * 2 ** i for i in range(18)]  # 0.25ms .. ~32s


def parse_mix(spec: str) -> dict[str, float]:
    """``"write:30,read:60,delete:10"`` → normalized weights."""
    weights: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if name not in OPS:
            raise ValueError(f"unknown op {name!r} in -mix")
        weights[name] = float(w) if w else 1.0
    total = sum(weights.values())
    if total <= 0:
        raise ValueError("empty -mix")
    return {k: v / total for k, v in weights.items()}


def parse_personas(spec: str) -> dict[str, float]:
    """``"native:40,s3:30,fuse:20,broker:10"`` → normalized weights."""
    weights: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if name not in PERSONAS:
            raise ValueError(
                f"unknown persona {name!r} in -personas "
                f"(choose from {', '.join(PERSONAS)})"
            )
        weights[name] = float(w) if w else 1.0
    total = sum(weights.values())
    if total <= 0:
        raise ValueError("empty -personas")
    return {k: v / total for k, v in weights.items()}


def _persona_seed(seed: int, name: str) -> int:
    """One persona's RNG seed off the single ``-seed``: a fixed
    per-name offset, so the same seed replays the same op/size/key
    sequence per persona and different personas never share streams."""
    return seed + 101 + PERSONAS.index(name) * 37


def parse_sizes(spec: str, default: int) -> tuple[int, int]:
    """``"1024"`` → (1024, 1024); ``"512-4096"`` → (512, 4096)."""
    if not spec:
        return default, default
    lo, _, hi = spec.partition("-")
    a = int(lo)
    b = int(hi) if hi else a
    if a <= 0 or b < a:
        raise ValueError(f"bad -sizes {spec!r}")
    return a, b


class KeySet:
    """The write log: fids with their written sizes, sampleable with
    zipfian rank popularity (earliest-written = hottest, the classic
    workload-generator convention). Deletes tombstone in place so the
    cumulative-weight array stays append-only."""

    def __init__(self, s: float = 1.1):
        self.s = s
        self._lock = threading.Lock()
        self._keys: list[tuple[str, int]] = []  # guarded-by: self._lock
        self._cum: list[float] = []  # guarded-by: self._lock
        self._dead: set[int] = set()  # guarded-by: self._lock
        self._total = 0.0  # guarded-by: self._lock

    def add(self, fid: str, size: int) -> None:
        with self._lock:
            rank = len(self._keys) + 1
            self._total += rank ** (-self.s)
            self._keys.append((fid, size))
            self._cum.append(self._total)

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys) - len(self._dead)

    def sample(self, rnd: random.Random) -> tuple[str, int] | None:
        """One live (fid, size), zipf-weighted by write rank."""
        with self._lock:
            n = len(self._keys)
            if n - len(self._dead) <= 0:
                return None
            for _ in range(64):
                i = bisect.bisect_left(
                    self._cum, rnd.random() * self._total
                )
                i = min(i, n - 1)
                if i not in self._dead:
                    return self._keys[i]
            # zipf landed on tombstones repeatedly: fall back to a
            # uniform scan from a random live offset
            start = rnd.randrange(n)
            for off in range(n):
                i = (start + off) % n
                if i not in self._dead:
                    return self._keys[i]
            return None

    def take(self, rnd: random.Random) -> tuple[str, int] | None:
        """Claim one live key for deletion (tombstoned atomically, so
        two delete workers never race to the same fid)."""
        with self._lock:
            n = len(self._keys)
            if n - len(self._dead) <= 0:
                return None
            start = rnd.randrange(n)
            for off in range(n):
                i = (start + off) % n
                if i not in self._dead:
                    self._dead.add(i)
                    return self._keys[i]
            return None


class PhaseStats:
    """Latencies (successes only), failures by error class, and byte
    counts for one op type within one phase."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._lat_ms: list[float] = []  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self.failures = 0  # guarded-by: self._lock
        self._errors: dict[str, int] = {}  # guarded-by: self._lock

    def ok(self, ms: float, n_bytes: int = 0) -> None:
        with self._lock:
            self._lat_ms.append(ms)
            self._bytes += n_bytes

    def fail(self, exc: BaseException) -> None:
        key = type(exc).__name__
        with self._lock:
            self.failures += 1
            self._errors[key] = self._errors.get(key, 0) + 1

    @property
    def attempts(self) -> int:
        with self._lock:
            return len(self._lat_ms) + self.failures

    def latencies_ms(self) -> list[float]:
        """Copy of the recorded success latencies — persona rollups
        merge every op's latencies into one per-protocol distribution
        for the ``protocols.*`` percentiles."""
        with self._lock:
            return list(self._lat_ms)

    def summary(self, wall: float) -> dict:
        with self._lock:
            lat = np.asarray(self._lat_ms, dtype=np.float64)
            failures = self.failures
            errors = dict(self._errors)
            n_bytes = self._bytes
        ok = int(lat.size)
        attempts = ok + failures
        out: dict = {
            "ops": attempts,
            "ok": ok,
            "failures": failures,
            "failure_rate": round(failures / attempts, 6)
            if attempts else 0.0,
            "wall_seconds": round(wall, 4),
            "ops_per_second": round(ok / wall, 2) if wall > 0 else 0.0,
            "bytes_per_second": round(n_bytes / wall, 1)
            if wall > 0 else 0.0,
        }
        if errors:
            out["errors"] = errors
        if ok:
            for q, key in ((50, "p50_ms"), (75, "p75_ms"),
                           (90, "p90_ms"), (95, "p95_ms"),
                           (99, "p99_ms")):
                out[key] = round(float(np.percentile(lat, q)), 3)
            out["max_ms"] = round(float(lat.max()), 3)
            counts, _ = np.histogram(
                lat, bins=[0.0] + _HIST_EDGES_MS
            )
            out["histogram_ms"] = {
                "le": _HIST_EDGES_MS,
                "counts": [int(c) for c in counts],
            }
        return out


class _FidPool:
    """Pre-assigned fids shared by the write workers.

    One ``/dir/assign?count=N`` round-trip refills the pool; each write
    then goes straight to the volume server. At scale (100 servers,
    thousands of writes/s) per-write assigns serialize on the master —
    batching amortizes that to one master round-trip per N writes."""

    def __init__(self, call, batch: int,
                 collection: str, replication: str):
        # `call(fn)` runs fn(master_url) — the workload's leader-aware
        # dispatcher, so pooled assigns survive a master failover
        self._call = call
        self.batch = batch
        self.collection = collection
        self.replication = replication
        self._lock = threading.Lock()
        # (fid, url, auth) ready to upload  # guarded-by: self._lock
        self._items: list[tuple[str, str, str]] = []

    def take(self) -> tuple[str, str, str]:
        with self._lock:
            if self._items:
                return self._items.pop()
        a = self._call(lambda u: operation.assign(
            u, count=self.batch,
            collection=self.collection, replication=self.replication,
        ))
        auths = a.auths
        fresh = [
            (f, a.url, auths[i] if i < len(auths) else "")
            for i, f in enumerate(a.fids)
        ]
        got = fresh.pop()
        with self._lock:
            self._items.extend(fresh)
        return got

    def discard_url(self, url: str) -> None:
        """Drop pooled fids on `url` — it just failed an upload, so the
        rest of its batch would fail too (server died mid-churn)."""
        with self._lock:
            self._items = [it for it in self._items if it[1] != url]


class _Workload:
    """Shared state + the three op bodies the workers draw from."""

    def __init__(self, master_url: str, collection: str,
                 sizes: tuple[int, int], seed: int, zipf_s: float,
                 replication: str = "", assign_batch: int = 1,
                 master_peers: list[str] | None = None):
        self.master_url = master_url
        self.collection = collection
        self.replication = replication
        self.sizes = sizes
        self.seed = seed
        self.keys = KeySet(s=zipf_s)
        # with peers, every master RPC goes through the leader-aware
        # ring (hint-following + /cluster/status re-resolution);
        # without, the classic direct path — byte-identical behavior
        # for every existing single-master round and its baselines
        self.ring = (
            MasterRing([master_url] + list(master_peers))
            if master_peers and len(
                set([master_url] + list(master_peers))
            ) > 1
            else None
        )
        self._pool = (
            _FidPool(self._call, assign_batch, collection, replication)
            if assign_batch > 1 else None
        )
        # one max-size random payload, sliced per write: content bytes
        # don't matter for load, allocation per op would
        payload_rng = np.random.default_rng(seed)
        self._payload = payload_rng.integers(
            0, 256, size=sizes[1], dtype=np.uint8
        ).tobytes()

    def _call(self, fn):
        """Run ``fn(master_url)`` — through the failover ring when one
        is configured, directly otherwise."""
        if self.ring is None:
            return fn(self.master_url)
        return self.ring.call(fn)

    def op_write(self, rnd: random.Random) -> int:
        lo, hi = self.sizes
        size = rnd.randint(lo, hi) if hi > lo else lo
        data = self._payload[:size]
        if self._pool is not None:
            # mirror upload_data's re-assign loop: a pooled fid may
            # point at a server churn just killed, and a batch-refill
            # may land mid-election — neither is the op's fault, so
            # draw a fresh fid (dead batch discarded) and retry before
            # counting a failure; every 4xx is a definitive answer
            last: Exception | None = None
            for _ in range(3):
                fid, url, auth = self._pool.take()
                try:
                    operation.upload(url, fid, data, jwt=auth)
                    last = None
                    break
                except http.HttpError as e:
                    self._pool.discard_url(url)
                    if 400 <= e.status < 500:
                        raise
                    last = e
                except OSError as e:
                    self._pool.discard_url(url)
                    last = e
            if last is not None:
                raise last
        else:
            fid, _ = self._call(lambda u: operation.upload_data(
                u, data,
                collection=self.collection,
                replication=self.replication,
            ))
        self.keys.add(fid, size)
        return size

    def op_read(self, rnd: random.Random) -> int:
        picked = self.keys.sample(rnd)
        if picked is None:
            # no keys yet (mixed phase bootstrap): write instead
            return self.op_write(rnd)
        fid, size = picked
        data = self._call(lambda u: operation.read_file(u, fid))
        # expected size comes from the write log, so variable-size
        # workloads verify correctly (the old single-size assert broke)
        if len(data) != size:
            raise RuntimeError(
                f"read {fid}: got {len(data)} bytes, wrote {size}"
            )
        return size

    def op_delete(self, rnd: random.Random) -> int:
        picked = self.keys.take(rnd)
        if picked is None:
            return self.op_write(rnd)
        fid, size = picked
        self._call(lambda u: operation.delete_file(u, fid))
        return 0

    def run(self, op: str, rnd: random.Random) -> int:
        if op == "write":
            return self.op_write(rnd)
        if op == "read":
            return self.op_read(rnd)
        return self.op_delete(rnd)


# ---- front-door personas ------------------------------------------------


def _xml_field(body: bytes, tag: str) -> str:
    """One element's text from a small S3 XML response (the gateway
    emits flat documents; a full parser here would be dead weight)."""
    text = body.decode("utf-8", "replace")
    open_t, close_t = f"<{tag}>", f"</{tag}>"
    i = text.find(open_t)
    j = text.find(close_t)
    if i < 0 or j < 0:
        raise RuntimeError(f"no <{tag}> in S3 response")
    return text[i + len(open_t):j]


class S3Persona:
    """S3 front-door workload: multipart PUT above MULTIPART_MIN
    (initiate → two part uploads → complete), simple PUT below, ranged
    GET verifying the returned length, and ListObjectsV2 — all through
    the HTTP gateway, with its own zipf-sampled key log."""

    BUCKET = "persona-bench"
    MULTIPART_MIN = 2048  # small floor so bench-size objects engage it

    def __init__(self, s3_url: str, sizes: tuple[int, int], seed: int,
                 zipf_s: float = 1.1):
        self.s3_url = s3_url
        self.sizes = sizes
        self.keys = KeySet(s=zipf_s)
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: self._lock
        payload_rng = np.random.default_rng(seed)
        self._payload = payload_rng.integers(
            0, 256, size=sizes[1], dtype=np.uint8
        ).tobytes()
        # CreateBucket is idempotent (re-PUT of an existing bucket
        # succeeds), so concurrent persona setups don't race
        http.request("PUT", f"{s3_url}/{self.BUCKET}")

    def _next_key(self) -> str:
        with self._lock:
            self._n += 1
            return f"obj-{self._n:08d}"

    def op_put(self, rnd: random.Random) -> int:
        lo, hi = self.sizes
        size = rnd.randint(lo, hi) if hi > lo else lo
        key = self._next_key()
        data = self._payload[:size]
        url = f"{self.s3_url}/{self.BUCKET}/{key}"
        if size >= self.MULTIPART_MIN:
            out = http.request("POST", f"{url}?uploads")
            upload_id = _xml_field(out, "UploadId")
            half = size // 2
            http.request(
                "PUT",
                f"{url}?partNumber=1&uploadId={upload_id}",
                data[:half],
            )
            http.request(
                "PUT",
                f"{url}?partNumber=2&uploadId={upload_id}",
                data[half:],
            )
            # completion assembles the stored parts server-side; the
            # gateway reads the part list from the filer, so an empty
            # body completes the upload
            http.request("POST", f"{url}?uploadId={upload_id}")
        else:
            http.request("PUT", url, data)
        self.keys.add(key, size)
        return size

    def op_get(self, rnd: random.Random) -> int:
        picked = self.keys.sample(rnd)
        if picked is None:
            return self.op_put(rnd)
        key, size = picked
        end = max(size // 2, 1) - 1
        data = http.request(
            "GET", f"{self.s3_url}/{self.BUCKET}/{key}",
            headers={"Range": f"bytes=0-{end}"},
        )
        if len(data) != end + 1:
            raise RuntimeError(
                f"ranged GET {key}: got {len(data)} bytes, "
                f"asked for {end + 1}"
            )
        return len(data)

    def op_list(self, rnd: random.Random) -> int:
        out = http.request(
            "GET",
            f"{self.s3_url}/{self.BUCKET}?list-type=2&max-keys=25",
        )
        if b"ListBucketResult" not in out:
            raise RuntimeError("unexpected ListObjectsV2 response")
        return len(out)

    def run(self, op: str, rnd: random.Random) -> int:
        if op == "put":
            return self.op_put(rnd)
        if op == "get":
            return self.op_get(rnd)
        return self.op_list(rnd)

    def close(self) -> None:
        pass


class FusePersona:
    """FUSE-style file churn through the WFS API (mount/wfs.py) with
    no kernel mount: create = create+write+flush+release, read
    verifies the recorded size, unlink removes a sampled file."""

    def __init__(self, filer_url, sizes: tuple[int, int],
                 seed: int, zipf_s: float = 1.1,
                 root: str = "/persona-bench"):
        # filer_url: one URL, a shard list, or a sharding.FilerRing —
        # WFS coerces via sharding.ring_of
        from ..mount.wfs import WFS

        # subscribe_meta=False: the persona is the only writer of its
        # subtree, so the meta-event long-poll thread is dead weight
        self.wfs = WFS(
            filer_url, filer_root=root, subscribe_meta=False
        )
        self.sizes = sizes
        self.keys = KeySet(s=zipf_s)
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: self._lock
        payload_rng = np.random.default_rng(seed)
        self._payload = payload_rng.integers(
            0, 256, size=sizes[1], dtype=np.uint8
        ).tobytes()

    def _next_path(self) -> str:
        with self._lock:
            self._n += 1
            return f"/f-{self._n:08d}"

    def op_create(self, rnd: random.Random) -> int:
        lo, hi = self.sizes
        size = rnd.randint(lo, hi) if hi > lo else lo
        path = self._next_path()
        fh = self.wfs.create(path, 0o644)
        self.wfs.write(path, self._payload[:size], 0, fh)
        self.wfs.flush(path, fh)
        self.wfs.release(path, fh)
        self.keys.add(path, size)
        return size

    def op_read(self, rnd: random.Random) -> int:
        picked = self.keys.sample(rnd)
        if picked is None:
            return self.op_create(rnd)
        path, size = picked
        data = self.wfs.read(path, size, 0, 0)
        if len(data) != size:
            raise RuntimeError(
                f"wfs read {path}: got {len(data)} bytes, wrote {size}"
            )
        return size

    def op_unlink(self, rnd: random.Random) -> int:
        picked = self.keys.take(rnd)
        if picked is None:
            return self.op_create(rnd)
        path, _size = picked
        self.wfs.unlink(path)
        return 0

    def run(self, op: str, rnd: random.Random) -> int:
        if op == "create":
            return self.op_create(rnd)
        if op == "read":
            return self.op_read(rnd)
        return self.op_unlink(rnd)

    def close(self) -> None:
        self.wfs.close()


class BrokerPersona:
    """Broker pub/sub against a seeded topic: publishes keyed
    messages, subscribes with offset-recovery-style reads — each read
    resumes from the tracked per-partition next_offset, verifies the
    returned offsets ascend, and advances the cursor. A broker 503
    (backpressure, offset recovery, unreachable owner) raises and is
    counted a FAILURE by the phase runner, never a latency."""

    def __init__(self, broker_url: str, seed: int,
                 partition_count: int = 4):
        self.broker_url = broker_url
        self.partition_count = partition_count
        self.topic = f"persona-{seed & 0xFFFF}"
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: self._lock
        # partition -> next offset to read  # guarded-by: self._lock
        self._next_offset: dict[int, int] = {}

    def op_publish(self, rnd: random.Random) -> int:
        with self._lock:
            self._n += 1
            n = self._n
        value = f"v-{n:08d}-{rnd.randrange(1 << 30):08x}"
        http.post_json(
            f"{self.broker_url}/publish",
            {
                "topic": self.topic,
                "key": f"k-{rnd.randrange(1 << 16):04x}",
                "value": value,
            },
        )
        return len(value)

    def op_subscribe(self, rnd: random.Random) -> int:
        partition = rnd.randrange(self.partition_count)
        with self._lock:
            since = self._next_offset.get(partition, 0)
        out = http.get_json(
            f"{self.broker_url}/subscribe?topic={self.topic}"
            f"&partition={partition}&offset={since}&limit=50"
        )
        msgs = out.get("messages") or []
        last = since - 1
        for m in msgs:
            off = m.get("offset", -1)
            if off <= last:
                raise RuntimeError(
                    f"subscribe {self.topic}/{partition}: offsets "
                    f"not ascending from {since} ({off} after {last})"
                )
            last = off
        with self._lock:
            cur = self._next_offset.get(partition, 0)
            self._next_offset[partition] = max(
                cur, int(out.get("next_offset", since))
            )
        return sum(len(m.get("value", "")) for m in msgs)

    def run(self, op: str, rnd: random.Random) -> int:
        if op == "publish":
            return self.op_publish(rnd)
        return self.op_subscribe(rnd)

    def close(self) -> None:
        pass


class _ProtocolRecorder:
    """Wraps a persona workload so every op ALSO feeds the process
    telemetry ledger (telemetry.snapshot.PROTOCOLS): the round report
    comes from PhaseStats, while the LIVE golden signals — the
    snapshot's ``protocols`` section, the cluster.health rollup, the
    flight-recorder ``proto_*_ops`` probes — come from here."""

    def __init__(self, protocol: str, inner):
        self.protocol = protocol
        self.inner = inner

    def run(self, op: str, rnd: random.Random) -> int:
        t = time.perf_counter()
        try:
            n = self.inner.run(op, rnd)
        except Exception:
            PROTOCOLS.record(
                self.protocol, time.perf_counter() - t, ok=False
            )
            raise
        PROTOCOLS.record(
            self.protocol, time.perf_counter() - t, ok=True
        )
        return n


class FrontDoors:
    """The protocol gateways a persona mix needs. Explicit URLs are
    used as-is; missing ones are spawned in-proc against the master in
    dependency order (filer → S3 gateway → broker, each wired into
    cluster telemetry via ``master_url``) and torn down by
    ``close()`` — a native-only mix spawns nothing."""

    def __init__(self, master_url: str, need_s3: bool = False,
                 need_fuse: bool = False, need_broker: bool = False,
                 filer_url="", s3_url: str = "",
                 broker_url: str = ""):
        # `filer_url` accepts one URL, an ordered shard list, or a
        # sharding.FilerRing (scale rounds with an fN spec pass the
        # harness ring) — gateways coerce via sharding.ring_of, so a
        # sharded tier's persona traffic exercises shard routing
        self._own: list = []
        self.filer_url = filer_url
        self.s3_url = s3_url
        self.broker_url = broker_url
        need_filer = need_fuse or (need_s3 and not s3_url) or (
            need_broker and not broker_url
        )
        if need_filer and not self.filer_url:
            from ..server.filer import FilerServer

            f = FilerServer(master_url)
            f.start()
            self._own.append(f)
            self.filer_url = f.url
        if need_s3 and not self.s3_url:
            from ..s3.s3api import S3ApiServer

            s3 = S3ApiServer(self.filer_url, master_url=master_url)
            s3.start()
            self._own.append(s3)
            self.s3_url = s3.url
        if need_broker and not self.broker_url:
            from ..filer import sharding
            from ..messaging.broker import MessageBroker

            b = MessageBroker(
                # the broker journals through one filer URL; on a
                # sharded tier that is the primary (its paths share
                # one routing key, so one shard owns them all)
                sharding.primary_url(self.filer_url),
                master_url=master_url,
            )
            b.start()
            self._own.append(b)
            self.broker_url = b.url

    def close(self) -> None:
        for server in reversed(self._own):
            try:
                server.stop()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass


def _run_phase(
    wl: _Workload,
    mix: dict[str, float],
    total: int,
    duration: float,
    concurrency: int,
    phase_seed: int,
    record: bool = True,
    trace: list | None = None,
) -> tuple[dict[str, PhaseStats], float]:
    """Run one phase (fixed op count, or a wall-clock window when
    ``duration`` > 0) at ``concurrency`` workers; returns per-op stats
    + wall seconds. A worker that hits an exception RECORDS A FAILURE
    and keeps pulling ops — it never dies silently leaving zeroed
    latencies behind. With ``trace``, every recorded attempt appends
    (monotonic_s, op, ok) — collected in per-worker lists and merged
    time-sorted after the join, so the hot path takes no shared lock."""
    stats = {op: PhaseStats(op) for op in mix}
    worker_traces: list[list] = [[] for _ in range(concurrency)]
    ops = sorted(mix)
    cum: list[float] = []
    acc = 0.0
    for op in ops:
        acc += mix[op]
        cum.append(acc)
    counter = {"i": 0}
    lock = threading.Lock()
    deadline = (
        time.monotonic() + duration if duration > 0 else None
    )
    t0 = time.perf_counter()

    def worker(widx: int) -> None:
        # per-worker RNG off the single benchmark seed: reruns with
        # the same -seed draw the same op/size/key sequences
        rnd = random.Random((phase_seed << 20) ^ (widx * 0x9E3779B1))
        while True:
            if deadline is not None:
                if time.monotonic() >= deadline:
                    return
            else:
                with lock:
                    if counter["i"] >= total:
                        return
                    counter["i"] += 1
            op = ops[bisect.bisect_left(cum, rnd.random() * acc)]
            t = time.perf_counter()
            try:
                n_bytes = wl.run(op, rnd)
            except Exception as e:  # noqa: BLE001 - counted, not fatal
                if record:
                    stats[op].fail(e)
                    if trace is not None:
                        worker_traces[widx].append(
                            (time.monotonic(), op, False)
                        )
            else:
                if record:
                    stats[op].ok(
                        (time.perf_counter() - t) * 1000, n_bytes
                    )
                    if trace is not None:
                        worker_traces[widx].append(
                            (time.monotonic(), op, True)
                        )

    # daemon so a Ctrl-C'd benchmark never pins the process on a
    # worker stuck in a slow request (they are joined below anyway)
    threads = [
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(concurrency)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if trace is not None:
        merged: list = []
        for wt in worker_traces:
            merged.extend(wt)
        trace.extend(sorted(merged))
    return stats, time.perf_counter() - t0


def _report_phase(name: str, summary: dict, concurrency: int, out) -> None:
    line = (
        f"\n{name} benchmark:\n"
        f"  requests: {summary['ops']} "
        f"({summary['failures']} failed), "
        f"concurrency: {concurrency}\n"
        f"  time taken: {summary['wall_seconds']:.2f} s\n"
        f"  requests/s: {summary['ops_per_second']:.2f}"
    )
    if "p50_ms" in summary:
        line += (
            f"\n  p50 {summary['p50_ms']:.2f}ms "
            f"p95 {summary['p95_ms']:.2f}ms "
            f"p99 {summary['p99_ms']:.2f}ms "
            f"max {summary['max_ms']:.2f}ms"
        )
    if summary.get("errors"):
        errs = ", ".join(
            f"{k}={v}" for k, v in sorted(summary["errors"].items())
        )
        line += f"\n  errors: {errs}"
    out(line)


def _pct_s(lat_s: list[float], q: float) -> float:
    if not lat_s:
        return 0.0
    return float(
        np.percentile(np.asarray(lat_s, dtype=np.float64), q)
    )


def _build_personas(wl: _Workload, doors: FrontDoors,
                    weights: dict[str, float],
                    size_range: tuple[int, int], zipf_s: float,
                    seed: int) -> dict[str, object]:
    """One driver per requested persona, each seeded off the single
    benchmark seed via its fixed per-name offset."""
    drivers: dict[str, object] = {}
    for name in sorted(weights):
        pseed = _persona_seed(seed, name)
        if name == "native":
            drivers[name] = wl
        elif name == "s3":
            drivers[name] = S3Persona(
                doors.s3_url, size_range, pseed, zipf_s
            )
        elif name == "fuse":
            drivers[name] = FusePersona(
                doors.filer_url, size_range, pseed, zipf_s
            )
        else:
            drivers[name] = BrokerPersona(doors.broker_url, pseed)
    return drivers


def _run_personas(
    drivers: dict[str, object],
    weights: dict[str, float],
    n: int,
    duration: float,
    concurrency: int,
    warmup: int,
    seed: int,
    out,
    trace: bool = False,
) -> tuple[dict, dict, int, float, dict[str, list]]:
    """Run every persona CONCURRENTLY against one fleet — one
    coordinator thread per persona, its weight's share of the worker
    pool inside — sharing the wall-clock window in duration mode and
    splitting the op budget by weight otherwise. Returns
    (protocols detail, native per-op summaries, total ok ops, max
    persona wall seconds, per-persona op traces)."""
    results: dict[str, tuple] = {}
    traces: dict[str, list] = {name: [] for name in weights}

    def run_one(name: str) -> None:
        w = weights[name]
        workers = max(1, round(concurrency * w))
        target = max(workers, round(n * w))
        mix = PERSONA_MIXES[name]
        rec = _ProtocolRecorder(name, drivers[name])
        pseed = _persona_seed(seed, name)
        if warmup > 0:
            _run_phase(
                rec, mix, max(1, round(warmup * w)), 0.0, workers,
                pseed ^ 0x5EED, record=False,
            )
        stats, wall = _run_phase(
            rec, mix, target, duration, workers, pseed,
            trace=traces[name] if trace else None,
        )
        results[name] = (stats, wall, workers)

    threads = [
        threading.Thread(target=run_one, args=(name,), daemon=True)
        for name in sorted(weights)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    protocols: dict[str, dict] = {}
    native_by_op: dict[str, dict] = {}
    total_ok = 0
    max_wall = 0.0
    for name in sorted(results):
        stats, wall, workers = results[name]
        lat_s: list[float] = []
        by_op: dict[str, dict] = {}
        ops_total = ok = failures = 0
        for op, st in sorted(stats.items()):
            if st.attempts == 0:
                continue
            summ = st.summary(wall)
            by_op[op] = summ
            ops_total += summ["ops"]
            ok += summ["ok"]
            failures += summ["failures"]
            lat_s.extend(ms / 1000.0 for ms in st.latencies_ms())
            _report_phase(f"{name}.{op}", summ, workers, out)
        lat_s.sort()
        protocols[name] = {
            "ops": ops_total,
            "ok": ok,
            "failures": failures,
            "error_rate": round(failures / ops_total, 6)
            if ops_total else 0.0,
            "wall_seconds": round(wall, 4),
            "ops_s": round(ok / wall, 2) if wall > 0 else 0.0,
            "p50_s": round(_pct_s(lat_s, 50), 6),
            "p99_s": round(_pct_s(lat_s, 99), 6),
            "max_s": round(lat_s[-1], 6) if lat_s else 0.0,
            "workers": workers,
            "by_op": by_op,
        }
        total_ok += ok
        max_wall = max(max_wall, wall)
        if name == "native":
            native_by_op = by_op
    return protocols, native_by_op, total_ok, max_wall, traces


def _push_to_master(wl: _Workload, result: dict, out) -> None:
    """Best-effort: hand the round summary to the master so the
    telemetry snapshot / cluster.health can surface load numbers in
    the same pane as SLO burn. Rides the workload's leader-aware
    dispatch — a summary pushed at the dead ex-leader helps nobody."""
    try:
        wl._call(lambda u: http.post_json(
            f"{u}/cluster/benchmark", result,
            retry=retry_mod.ADMIN,
        ))
    except Exception as e:  # noqa: BLE001 - telemetry, not the bench
        out(f"(could not push summary to master: {e})")


def run_benchmark(
    master_url: str,
    n: int = 1000,
    size: int = 1024,
    concurrency: int = 16,
    collection: str = "benchmark",
    do_write: bool = True,
    do_read: bool = True,
    mix: str = "",
    sizes: str = "",
    zipf_s: float = 1.1,
    warmup: int = 0,
    duration: float = 0.0,
    seed: int = 0,
    replication: str = "",
    assign_batch: int = 1,
    master_peers: list[str] | None = None,
    op_trace: bool = False,
    personas: str = "",
    # one URL, an ordered shard list, or a sharding.FilerRing
    filer_url="",
    s3_url: str = "",
    broker_url: str = "",
    json_path: str = "",
    check_path: str = "",
    check_threshold: float | None = None,
    out=print,
) -> int:
    size_range = parse_sizes(sizes, size)
    wl = _Workload(
        master_url, collection, size_range, seed, zipf_s,
        replication=replication, assign_batch=assign_batch,
        master_peers=master_peers,
    )
    global LAST_OP_TRACE, LAST_PERSONA_TRACES
    LAST_OP_TRACE = [] if op_trace else None
    LAST_PERSONA_TRACES = None
    phases: dict[str, dict] = {}
    persona_protocols: dict | None = None
    total_ok = 0
    total_wall = 0.0

    def run_and_record(phase_mix: dict[str, float],
                       phase_seed: int) -> None:
        nonlocal total_ok, total_wall
        if warmup > 0:
            _run_phase(
                wl, phase_mix, warmup, 0.0, concurrency,
                phase_seed ^ 0x5EED, record=False,
            )
        stats, wall = _run_phase(
            wl, phase_mix, n, duration, concurrency, phase_seed,
            trace=LAST_OP_TRACE,
        )
        total_wall += wall
        for op, st in sorted(stats.items()):
            if st.attempts == 0:
                continue
            summ = st.summary(wall)
            phases[op] = summ
            total_ok += summ["ok"]
            _report_phase(op, summ, concurrency, out)

    if personas:
        weights = parse_personas(personas)
        doors = FrontDoors(
            master_url,
            need_s3="s3" in weights,
            need_fuse="fuse" in weights,
            need_broker="broker" in weights,
            filer_url=filer_url, s3_url=s3_url,
            broker_url=broker_url,
        )
        drivers: dict[str, object] = {}
        try:
            drivers = _build_personas(
                wl, doors, weights, size_range, zipf_s, seed
            )
            (persona_protocols, native_by_op, total_ok,
             total_wall, traces) = _run_personas(
                drivers, weights, n, duration, concurrency,
                warmup, seed, out, trace=op_trace,
            )
        finally:
            for d in drivers.values():
                if d is not wl:
                    try:
                        d.close()
                    except Exception:  # noqa: BLE001 - teardown
                        pass
            doors.close()
        phases.update(native_by_op)
        if op_trace:
            LAST_PERSONA_TRACES = traces
            # the flat trace keeps native ops under their bare names
            # (scale/round.py's failover-window intersection keys on
            # "write") and prefixes every other persona's
            merged: list = []
            for name, tr in traces.items():
                for t, op, ok_flag in tr:
                    merged.append((
                        t,
                        op if name == "native" else f"{name}.{op}",
                        ok_flag,
                    ))
            LAST_OP_TRACE = sorted(merged)
    elif mix:
        run_and_record(parse_mix(mix), seed + 1)
    else:
        if do_write:
            run_and_record({"write": 1.0}, seed + 1)
        if do_read and len(wl.keys):
            run_and_record({"read": 1.0}, seed + 2)

    overall = total_ok / total_wall if total_wall > 0 else 0.0
    result = {
        "metric": "load_ops_per_second",
        "value": round(overall, 2),
        "unit": "ops/s",
        "detail": {
            "phases": phases,
            "concurrency": concurrency,
            "n": n,
            "sizes": f"{size_range[0]}-{size_range[1]}",
            "mix": mix or ("personas" if personas else "write,read"),
            "zipf_s": zipf_s,
            "seed": seed,
            "warmup": warmup,
            "duration": duration,
            "collection": collection,
            "replication": replication,
            "assign_batch": assign_batch,
        },
    }
    if personas:
        result["detail"]["personas"] = personas
        result["detail"]["protocols"] = persona_protocols
    global LAST_RESULT
    LAST_RESULT = result
    out(
        f"\noverall: {result['value']:.2f} ops/s over "
        f"{total_wall:.2f}s recorded"
    )
    if json_path:
        benchgate.stamp_provenance(
            result, os.path.dirname(json_path) or ".", "LOAD"
        )
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1)
        out(f"wrote {json_path}")
    _push_to_master(wl, result, out)
    if check_path:
        return run_check(result, check_path, check_threshold, out=out)
    return 0


def run_check(
    result: dict,
    baseline_path: str,
    threshold: float | None = None,
    out=print,
) -> int:
    """Gate a LOAD result against a stored round: 0 = within
    threshold, 1 = regression (ops/s drop, or p50/p99/max/failure-rate
    rise, >= threshold), 2 = unusable baseline."""
    thr = threshold if threshold is not None else benchgate.CHECK_THRESHOLD
    try:
        baseline = benchgate.load_round(baseline_path)
    except (OSError, ValueError) as e:
        out(f"--check: cannot load baseline {baseline_path}: {e}")
        return 2
    # kind-registry dispatch (shared with bench.py --check and
    # weed scale -check): a LOAD result picks the load flattener
    flatten, lower_is_better = benchgate.gate_kind(result, baseline)
    msgs = benchgate.check_regression(
        result, baseline, thr,
        flatten=flatten,
        lower_is_better=lower_is_better,
    )
    if msgs:
        out(
            f"LOAD REGRESSION vs {baseline_path} "
            f"(threshold {thr:.0%}):"
        )
        for m in msgs:
            out("  " + m)
        return 1
    compared = benchgate.compared_metrics(
        result, baseline, flatten=flatten
    )
    out(
        f"load check vs {baseline_path}: OK "
        f"({len(compared)} metrics within {thr:.0%})"
    )
    return 0
