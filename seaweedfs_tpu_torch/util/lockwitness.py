"""Runtime lock witness: the dynamic half of weedcheck's
interprocedural concurrency pass (tools/weedcheck/concpass.py).

Python has no ``-race`` flag; this is the repo's lockdep. When
installed (the tier-1 pytest plugin in tests/conftest.py does it
before any package module is imported), ``threading.Lock`` /
``RLock`` / ``Condition`` are replaced by factories that wrap every
lock CREATED FROM PACKAGE CODE (decided by the creating frame's file;
stdlib-internal locks — queue, logging, Event — stay untouched) in a
thin recorder:

* every lock is identified by its **creation site** (file:line) — the
  same identity the static call graph indexes, so dynamic facts map
  onto static lock names (``Filer._lock``);
* each thread keeps its held-stack; acquiring B while holding A
  records the edge A→B once, with a compact stack fingerprint from
  the first time it was seen;
* RLock reentrancy adds no edge; ``Condition.wait`` releases its own
  lock for the wait and records the reacquisition against everything
  else the thread still holds (the classic wait-while-holding-two
  pattern surfaces as real edges);
* nesting two locks from the SAME creation site (two Volume
  instances) is tracked separately (``same_site``) — per-instance
  ordering is invisible statically and a site-level self-edge would
  always be a false cycle.

The recorder's fast path is a thread-local list walk plus one raw
(unwrapped) registry lock taken only to bump an edge counter; a
bounded ring of recent acquisitions is kept for post-mortem debugging.

Since the flight-recorder PR the wrappers double as a **contention
profiler**: every acquire first tries the lock non-blocking — success
is the uncontended fast path; failure marks the acquire *blocked* and
times the blocking acquire on ``perf_counter`` into a per-site
exponential wait histogram (``WAIT_BOUNDS``: 1µs..~8s), alongside
hold-duration totals measured from first acquire to final release.
The per-site counters live behind their own raw (unwrapped) locks so
profiling one contended site never serializes the others; the first
slow blocked acquire (>1ms) captures a compact stack fingerprint of
the *blocked* thread. ``contention_snapshot()`` exposes the whole
table; ``telemetry/recorder.py`` turns it into
``seaweedfs_lock_wait_seconds{site}`` and the ``cluster.contention``
shell view.

At session end the pytest plugin merges the graph into
``/tmp/lockgraph.json``, fails the run on any cycle in the observed
acquisition-order graph, and cross-checks every dynamic edge against
the static may-graph — an unjustifiable edge means the static
call-graph builder has a hole and is reported, never silently
ignored. ``SEAWEEDFS_LOCKWITNESS=0`` disables the whole apparatus.

The port's copy of ``seaweedfs_tpu/util/lockwitness.py``, scoped to the
port's package directory. Two differences let it share a process with
the reference's witness (which the test suite installs first):

* its wrapped locks are built on the interpreter's own primitives
  (``_thread.allocate_lock``, ``_thread.RLock`` and the
  ``threading.Condition`` class), never on whatever ``threading.Lock``
  is at import, so it never wraps another witness's wrappers;
* :func:`install` remembers the factories it displaced and
  :func:`uninstall` puts exactly those back, so installing and removing
  this witness leaves another witness's factories in place.

A lock created outside the port's package while this witness is
installed is a plain interpreter lock, recorded by neither witness.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from _thread import RLock as _raw_rlock
from _thread import allocate_lock as _raw_lock
from collections import deque


def _interpreter_condition() -> type:
    """The ``threading.Condition`` class itself, even when another
    witness has already replaced the module attribute with a factory:
    ``Event`` builds its condition through that factory with an
    explicit lock, which every witness hands straight to the class."""
    cond = threading.Condition
    if isinstance(cond, type):
        return cond
    return type(threading.Event()._cond)


_REAL_LOCK = _raw_lock
_REAL_RLOCK = _raw_rlock
_REAL_CONDITION = _interpreter_condition()

_WITNESS: "LockWitness | None" = None

# wait-histogram bounds for blocked acquires: exponential 1µs..~8.4s,
# the same shape stats/metrics.Histogram uses so the per-site counts
# merge straight into seaweedfs_lock_wait_seconds{site}
WAIT_BUCKET_START = 1e-6
WAIT_BUCKET_COUNT = 24
WAIT_BOUNDS = [
    WAIT_BUCKET_START * 2.0**i for i in range(WAIT_BUCKET_COUNT)
]
# a blocked acquire slower than this captures the blocked thread's
# stack fingerprint (once per site)
_STACK_CAPTURE_WAIT = 1e-3
# a Condition post-wait reacquire faster than this is an instant
# handoff, not contention
_RESTORE_BLOCKED_MIN = 1e-5


def _stack_fingerprint(frame, limit: int = 6) -> str:
    return "; ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
        for f in traceback.extract_stack(frame, limit=limit)
    )


def _site_str(filename: str, lineno: int) -> str:
    return f"{os.path.abspath(filename)}:{lineno}"


class _SiteStats:
    """Per-creation-site contention counters. Guarded by its own raw
    (unwitnessed) lock so the profiler never couples two sites — a
    thread blocked on the aggregator lock must not also queue behind
    whoever is updating the broadcaster's numbers."""

    __slots__ = (
        "_lk", "acquires", "blocked", "wait_sum", "wait_max",
        "wait_buckets", "hold_count", "hold_sum", "hold_max",
        "blocked_stack",
    )

    def __init__(self):
        self._lk = _raw_lock()
        self.acquires = 0
        self.blocked = 0
        self.wait_sum = 0.0
        self.wait_max = 0.0
        self.wait_buckets = [0] * WAIT_BUCKET_COUNT
        self.hold_count = 0
        self.hold_sum = 0.0
        self.hold_max = 0.0
        self.blocked_stack = ""

    def note_acquire(self, wait: float, blocked: bool) -> None:
        with self._lk:
            self.acquires += 1
            if not blocked:
                return
            self.blocked += 1
            self.wait_sum += wait
            if wait > self.wait_max:
                self.wait_max = wait
            # inline exponential bucket index (bisect over 24 bounds
            # costs more than the arithmetic on this hot path)
            i = 0
            bound = WAIT_BUCKET_START
            while wait > bound and i < WAIT_BUCKET_COUNT - 1:
                bound *= 2.0
                i += 1
            if wait <= bound:
                self.wait_buckets[i] += 1

    def note_release(self, hold: float) -> None:
        with self._lk:
            self.hold_count += 1
            self.hold_sum += hold
            if hold > self.hold_max:
                self.hold_max = hold

    def set_stack(self, stack: str) -> None:
        with self._lk:
            if not self.blocked_stack:
                self.blocked_stack = stack

    def to_dict(self) -> dict:
        with self._lk:
            return {
                "acquires": self.acquires,
                "blocked": self.blocked,
                "wait_sum": self.wait_sum,
                "wait_max": self.wait_max,
                "wait_buckets": list(self.wait_buckets),
                "hold_count": self.hold_count,
                "hold_sum": self.hold_sum,
                "hold_max": self.hold_max,
                "blocked_stack": self.blocked_stack,
            }


class _Held:
    __slots__ = ("lock", "site", "depth", "t0")

    def __init__(self, lock, site, t0):
        self.lock = lock
        self.site = site
        self.depth = 1
        self.t0 = t0


class _WitnessBase:
    """Shared acquire/release bookkeeping + the full Condition lock
    protocol, so a wrapped lock drops into ``threading.Condition``."""

    __slots__ = ("_w", "_inner", "_site", "_stats")

    def __init__(
        self, witness: "LockWitness", inner, site: str,
        stats: _SiteStats | None = None,
    ):
        self._w = witness
        self._inner = inner
        self._site = site
        # factories pass the witness's canonical per-site stats; a
        # directly constructed wrapper (unit tests) gets its own
        self._stats = stats if stats is not None else _SiteStats()

    def acquire(self, blocking=True, timeout=-1):
        # contention probe: a non-blocking try first — success IS the
        # uncontended fast path (same C call the plain acquire pays);
        # failure means someone holds the lock, so the blocking
        # acquire below is timed as the blocked wait
        if self._inner.acquire(False):
            self._stats.note_acquire(0.0, False)
            self._w._note_acquire(self)
            return True
        if not blocking:
            self._stats.note_acquire(0.0, True)
            return False
        t0 = time.perf_counter()
        ok = self._inner.acquire(True, timeout)
        wait = time.perf_counter() - t0
        self._stats.note_acquire(wait, True)
        if wait > _STACK_CAPTURE_WAIT and not self._stats.blocked_stack:
            self._stats.set_stack(_stack_fingerprint(sys._getframe(1)))
        if ok:
            self._w._note_acquire(self)
        return ok

    def release(self):
        self._inner.release()
        self._w._note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- threading.Condition protocol -----------------------------------

    def _acquire_restore(self, state):
        # the post-wait reacquire blocks until the notifier releases;
        # that IS lock wait, timed like any blocked acquire (instant
        # reacquires under _RESTORE_BLOCKED_MIN count as uncontended)
        t0 = time.perf_counter()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        wait = time.perf_counter() - t0
        self._stats.note_acquire(wait, wait >= _RESTORE_BLOCKED_MIN)
        self._w._note_acquire(self)

    def _release_save(self):
        self._w._note_release_all(self)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock fallback: owned iff this thread holds it
        return self._w._holds(self)

    def __repr__(self):
        return f"<witness {self._inner!r} @ {self._site}>"


class _WLock(_WitnessBase):
    __slots__ = ()


class _WRLock(_WitnessBase):
    __slots__ = ()


class LockWitness:
    def __init__(self, package_dir: str):
        self.package_dir = os.path.abspath(package_dir) + os.sep
        self._reg = _raw_lock()
        # site -> {"kind": "Lock"|"RLock"|"Condition", "created": n}
        self.locks: dict[str, dict] = {}
        # (site_a, site_b) -> {"count": n, "stack": str}
        self.edges: dict[tuple, dict] = {}
        # site -> count of same-site (cross-instance) nestings
        self.same_site: dict[str, int] = {}
        # site -> _SiteStats (contention profiler); all instances
        # created at one site share one stats block
        self.site_stats: dict[str, _SiteStats] = {}
        self.ring: deque = deque(maxlen=256)
        self._tls = threading.local()
        self.installed = False
        # the (Lock, RLock, Condition) factories install() displaced,
        # put back by uninstall()
        self.displaced: tuple | None = None

    # -- bookkeeping -----------------------------------------------------

    def _held_list(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def _holds(self, lock) -> bool:
        return any(h.lock is lock for h in self._held_list())

    def _note_acquire(self, lock) -> None:
        held = self._held_list()
        for h in held:
            if h.lock is lock:
                h.depth += 1
                return  # reentrant: no new edge
        site = lock._site
        self.ring.append(
            (threading.current_thread().name, "acquire", site)
        )
        if held:
            fingerprint = None
            with self._reg:
                for h in held:
                    if h.site == site:
                        self.same_site[site] = (
                            self.same_site.get(site, 0) + 1
                        )
                        continue
                    key = (h.site, site)
                    ent = self.edges.get(key)
                    if ent is None:
                        if fingerprint is None:
                            fingerprint = _stack_fingerprint(
                                sys._getframe(2)
                            )
                        self.edges[key] = {
                            "count": 1, "stack": fingerprint,
                        }
                    else:
                        ent["count"] += 1
        held.append(_Held(lock, site, time.perf_counter()))

    def _note_release(self, lock) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                held[i].depth -= 1
                if held[i].depth == 0:
                    lock._stats.note_release(
                        time.perf_counter() - held[i].t0
                    )
                    del held[i]
                return

    def _note_release_all(self, lock) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                lock._stats.note_release(
                    time.perf_counter() - held[i].t0
                )
                del held[i]
                return

    def _in_scope(self, filename: str) -> bool:
        return os.path.abspath(filename).startswith(self.package_dir)

    def _register_site(self, site: str, kind: str) -> _SiteStats:
        with self._reg:
            ent = self.locks.setdefault(
                site, {"kind": kind, "created": 0}
            )
            ent["created"] += 1
            return self.site_stats.setdefault(site, _SiteStats())

    # -- patched factories ----------------------------------------------

    def _lock_factory(self):
        inner = _REAL_LOCK()
        frame = sys._getframe(1)
        if not self._in_scope(frame.f_code.co_filename):
            return inner
        site = _site_str(frame.f_code.co_filename, frame.f_lineno)
        stats = self._register_site(site, "Lock")
        return _WLock(self, inner, site, stats)

    def _rlock_factory(self):
        inner = _REAL_RLOCK()
        frame = sys._getframe(1)
        if not self._in_scope(frame.f_code.co_filename):
            return inner
        site = _site_str(frame.f_code.co_filename, frame.f_lineno)
        stats = self._register_site(site, "RLock")
        return _WRLock(self, inner, site, stats)

    def _condition_factory(self, lock=None):
        if lock is not None:
            return _REAL_CONDITION(lock)
        frame = sys._getframe(1)
        if not self._in_scope(frame.f_code.co_filename):
            return _REAL_CONDITION()
        site = _site_str(frame.f_code.co_filename, frame.f_lineno)
        stats = self._register_site(site, "Condition")
        return _REAL_CONDITION(
            _WRLock(self, _REAL_RLOCK(), site, stats)
        )

    # -- views -----------------------------------------------------------

    def short_site(self, site: str) -> str:
        """Package-relative ``path:line`` — the bounded label the
        contention metrics publish (raw sites are absolute paths)."""
        if site.startswith(self.package_dir):
            return site[len(self.package_dir):]
        path, _, line = site.rpartition(":")
        return f"{os.path.basename(path)}:{line}" if path else site

    def contention_snapshot(self) -> dict[str, dict]:
        """Per-site contention table keyed by short site name. Each
        entry is a _SiteStats.to_dict() plus ``kind`` and the raw
        ``site``; sites never acquired are omitted."""
        with self._reg:
            items = [
                (site, stats, self.locks.get(site, {}).get("kind", "?"))
                for site, stats in self.site_stats.items()
            ]
        out: dict[str, dict] = {}
        for site, stats, kind in items:
            d = stats.to_dict()
            if d["acquires"] == 0:
                continue
            d["kind"] = kind
            d["site"] = site
            out[self.short_site(site)] = d
        return out

    def snapshot(self) -> dict:
        """Copy of the observed graph (site-keyed, JSON-friendly)."""
        with self._reg:
            return {
                "locks": {s: dict(v) for s, v in self.locks.items()},
                "edges": [
                    {"from": a, "to": b, **dict(v)}
                    for (a, b), v in self.edges.items()
                ],
                "same_site": dict(self.same_site),
            }


def find_cycles(edges: list[dict]) -> list[list[str]]:
    """Strongly-connected components of size >= 2 in the observed
    acquisition-order graph (site or name keyed — caller's choice)."""
    adj: dict[str, set] = {}
    nodes: set = set()
    for e in edges:
        a, b = e["from"], e["to"]
        if a == b:
            continue
        nodes.update((a, b))
        adj.setdefault(a, set()).add(b)

    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set = set()
    stack: list = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) >= 2:
                    out.append(sorted(comp))
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for n in sorted(nodes):
        if n not in index:
            strongconnect(n)
    return out


def validate(
    snapshot: dict,
    site_name,
    may_edges: set,
    wildcards: set,
) -> dict:
    """Cross-check the dynamic graph against the static model.

    ``site_name(path, line) -> canonical name | None`` maps creation
    sites onto static lock names; ``may_edges`` is the generous static
    lock-order graph over those names; ``wildcards`` are holder names
    the static pass saw making calls it could not resolve (any edge
    from them is statically justifiable). Returns the merged report:
    named edges with their justification, dynamic cycles (name-level),
    and the two failure lists — ``cycles`` and ``missing`` (edges the
    static model cannot explain = call-graph holes)."""

    def name_of(site: str):
        path, _, line = site.rpartition(":")
        try:
            return site_name(path, int(line))
        except ValueError:
            return None

    named_edges = []
    missing = []
    for e in snapshot["edges"]:
        na, nb = name_of(e["from"]), name_of(e["to"])
        rec = {
            "from": na or e["from"],
            "to": nb or e["to"],
            "count": e["count"],
            "stack": e.get("stack", ""),
        }
        if na is None or nb is None:
            rec["static"] = "unknown-site"
            missing.append(rec)
        elif na == nb:
            rec["static"] = "same-name"
        elif (na, nb) in may_edges:
            rec["static"] = "edge"
        elif na in wildcards:
            rec["static"] = "wildcard-holder"
        else:
            rec["static"] = "MISSING"
            missing.append(rec)
        named_edges.append(rec)
    cycles = find_cycles(
        [e for e in named_edges if e["from"] != e["to"]]
    )
    locks_named = {}
    for site, info in snapshot["locks"].items():
        locks_named[site] = dict(info, name=name_of(site))
    return {
        "locks": locks_named,
        "edges": sorted(
            named_edges, key=lambda e: (e["from"], e["to"])
        ),
        "same_site": snapshot["same_site"],
        "cycles": cycles,
        "missing": missing,
    }


def install(package_dir: str | None = None) -> LockWitness:
    """Monkeypatch the threading lock factories. Idempotent; returns
    the process-wide witness."""
    global _WITNESS
    if _WITNESS is not None and _WITNESS.installed:
        return _WITNESS
    if package_dir is None:
        package_dir = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
    w = _WITNESS or LockWitness(package_dir)
    w.displaced = (threading.Lock, threading.RLock, threading.Condition)
    threading.Lock = w._lock_factory
    threading.RLock = w._rlock_factory
    threading.Condition = w._condition_factory
    w.installed = True
    _WITNESS = w
    return w


def uninstall() -> None:
    """Put back the factories :func:`install` displaced (another
    witness's, or the interpreter's own). A no-op when not installed."""
    w = _WITNESS
    if w is None or not w.installed:
        return
    threading.Lock, threading.RLock, threading.Condition = w.displaced
    w.displaced = None
    w.installed = False


def current() -> LockWitness | None:
    return _WITNESS
