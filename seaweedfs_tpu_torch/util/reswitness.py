"""Runtime resource witness: the dynamic half of weedcheck's
resource-lifecycle pass (tools/weedcheck/respass.py).

The static pass proves a handle cannot leak on any *modeled* path;
this witness catches what the model can't see — handles kept alive by
caches, registries, or monkeypatched indirection, and leaks that only
manifest under the real test workload. When installed (the tier-1
pytest plugin in tests/conftest.py does it before any package module
is imported), ``builtins.open``, ``threading.Thread.__init__`` and
``concurrent.futures.ThreadPoolExecutor.__init__`` are wrapped so
every resource CREATED FROM PACKAGE CODE (decided by the creating
frame's file, exactly like util/lockwitness.py; stdlib-internal
resources — logging file handles, executor worker threads — stay
invisible) is registered under its **creation site** (file:line):

* registration is a weakref; a collected handle drops out on its own,
  and the census only counts handles that are still *live* (an open
  file not yet closed, a thread still running, an executor not yet
  shut down) — GC latency never inflates a count;
* the first registration per site captures a compact creation-stack
  fingerprint, so a flagged leak names the code that created it, not
  just a file:line;
* ``census()`` returns live counts per (kind, site) — the same
  identity respass findings carry, so dynamic leaks map onto static
  acquisition sites.

The pytest plugin calls ``note_boundary()`` after every test and at
session end runs ``find_leaks`` over the recorded series: a (kind,
site) whose live count grew **monotonically** across test boundaries
— never dipping, total growth of at least ``MIN_GROWTH``, spread over
at least ``MIN_STEPS`` distinct increases — is a leak; one global
singleton appearing is not, and a per-test resource that is torn down
shows a dip and is not. A flagged leak FAILS the session with the
offending creation stacks named. ``SEAWEEDFS_RESWITNESS=0`` disables
the whole apparatus.

The fd/thread *process* peaks over a scale round are recorded
separately by the flight recorder's ``fds``/``threads`` probes and
gated direction-aware (with noise floors) by ``util/benchgate.py``.

The port's copy of ``seaweedfs_tpu/util/reswitness.py``, scoped to the
port's package directory. It shares a process with the reference's
witness (which the test suite installs first): :func:`install` remembers
the three factories it displaced and its wrappers call through to them,
and :func:`uninstall` puts exactly those back, so installing and
removing this witness leaves another witness's factories in place. A
resource created outside the port's package while this witness is
installed is recorded by neither witness.
"""

from __future__ import annotations

import builtins
import os
import sys
import threading
import traceback
import weakref
from _thread import allocate_lock as _raw_lock
from concurrent.futures import ThreadPoolExecutor

_WITNESS: "ResWitness | None" = None

# growth-tracker thresholds: a leak must grow by at least MIN_GROWTH
# handles total, in at least MIN_STEPS distinct increases, without
# ever dipping — a process-global singleton (one step, growth 1) and
# per-test resources that are torn down (the dip) both stay below
KINDS = ("files", "threads", "executors")
MIN_GROWTH = 4
MIN_STEPS = 3


def enabled() -> bool:
    return os.environ.get("SEAWEEDFS_RESWITNESS", "1") != "0"


def _stack_fingerprint(frame, limit: int = 6) -> str:
    return "; ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
        for f in traceback.extract_stack(frame, limit=limit)
    )


def _site_str(filename: str, lineno: int) -> str:
    return f"{os.path.abspath(filename)}:{lineno}"


class ResWitness:
    """Process-wide resource registry. Factories register weakrefs
    keyed by creation site; censuses count what is still live."""

    def __init__(self, package_dir: str):
        self._reg = _raw_lock()
        self.package_dirs = (os.path.abspath(package_dir) + os.sep,)
        # kind -> {id(obj): (weakref, site)}  guarded-by: self._reg
        self._live: dict[str, dict[int, tuple]] = {
            k: {} for k in KINDS
        }
        # site -> creation-stack fingerprint (first seen)
        self.site_stacks: dict[str, str] = {}  # guarded-by: self._reg
        # filename -> in-scope decision (open() is hot; the abspath +
        # prefix test must run once per file, not once per call)
        self._scope_cache: dict[str, bool] = {}  # guarded-by: self._reg
        # census series recorded at test boundaries:
        # list of {kind: {site: live_count}}
        self.boundaries: list[dict] = []  # guarded-by: self._reg
        self.installed = False

    # -- scope -----------------------------------------------------------

    def add_scope(self, directory: str) -> None:
        """Extend the package scope (tests use this to make their own
        creation frames visible)."""
        with self._reg:
            self.package_dirs = self.package_dirs + (
                os.path.abspath(directory) + os.sep,
            )
            self._scope_cache.clear()

    def _in_scope(self, filename: str) -> bool:
        cached = self._scope_cache.get(filename)
        if cached is not None:
            return cached
        path = os.path.abspath(filename)
        ok = any(path.startswith(d) for d in self.package_dirs)
        with self._reg:
            self._scope_cache[filename] = ok
        return ok

    # -- registration ----------------------------------------------------

    def _track(self, kind: str, obj, frame) -> None:
        site = _site_str(frame.f_code.co_filename, frame.f_lineno)
        key = id(obj)
        reg = self._live[kind]

        def _gone(_ref, key=key, reg=reg):
            with self._reg:
                reg.pop(key, None)

        try:
            ref = weakref.ref(obj, _gone)
        except TypeError:
            return  # not weakref-able: never registered, never counted
        # fingerprinting reads source lines (linecache opens files);
        # compute it before taking the registry lock
        stack = (
            _stack_fingerprint(frame)
            if site not in self.site_stacks else None
        )
        with self._reg:
            reg[key] = (ref, site)
            if stack is not None:
                self.site_stacks.setdefault(site, stack)

    # -- patched factories ----------------------------------------------

    def _open(self, *args, **kwargs):
        f = self.displaced[0](*args, **kwargs)
        frame = sys._getframe(1)
        if self._in_scope(frame.f_code.co_filename):
            self._track("files", f, frame)
        return f

    def _thread_init(self, thread, *args, **kwargs):
        self.displaced[1](thread, *args, **kwargs)
        frame = sys._getframe(2)
        if self._in_scope(frame.f_code.co_filename):
            self._track("threads", thread, frame)

    def _executor_init(self, pool, *args, **kwargs):
        self.displaced[2](pool, *args, **kwargs)
        frame = sys._getframe(2)
        if self._in_scope(frame.f_code.co_filename):
            self._track("executors", pool, frame)

    # -- censuses --------------------------------------------------------

    @staticmethod
    def _is_live(kind: str, obj) -> bool:
        if kind == "files":
            return not getattr(obj, "closed", True)
        if kind == "threads":
            return obj.is_alive()
        return not getattr(obj, "_shutdown", False)

    def census(self) -> dict[str, dict[str, int]]:
        """Live counts per creation site:
        ``{"files": {site: n}, "threads": ..., "executors": ...}``.
        Dead weakrefs and released handles are dropped, not counted."""
        with self._reg:
            snap = {
                kind: list(reg.values())
                for kind, reg in self._live.items()
            }
        out: dict[str, dict[str, int]] = {}
        for kind, entries in snap.items():
            counts: dict[str, int] = {}
            for ref, site in entries:
                obj = ref()
                if obj is not None and self._is_live(kind, obj):
                    counts[site] = counts.get(site, 0) + 1
            out[kind] = counts
        return out

    def totals(self) -> dict[str, int]:
        return {
            kind: sum(sites.values())
            for kind, sites in self.census().items()
        }

    # -- growth tracking -------------------------------------------------

    def note_boundary(self) -> None:
        """Record a census at a test boundary for the leak check."""
        c = self.census()
        with self._reg:
            self.boundaries.append(c)

    def leaks(self, min_growth: int = MIN_GROWTH,
              min_steps: int = MIN_STEPS) -> list[dict]:
        with self._reg:
            history = list(self.boundaries)
            stacks = dict(self.site_stacks)
        out = find_leaks(history, min_growth=min_growth,
                         min_steps=min_steps)
        for leak in out:
            leak["stack"] = stacks.get(leak["site"], "")
        return out

    def short_site(self, site: str) -> str:
        for d in self.package_dirs:
            if site.startswith(d):
                return site[len(d):]
        path, _, line = site.rpartition(":")
        return f"{os.path.basename(path)}:{line}" if path else site


def find_leaks(history: list[dict], min_growth: int = MIN_GROWTH,
               min_steps: int = MIN_STEPS) -> list[dict]:
    """Flag (kind, site) series that grew monotonically across the
    recorded boundaries: never decreasing, total growth >=
    ``min_growth``, with growth spread over >= ``min_steps`` distinct
    increases. ``history`` is a list of census dicts; a site missing
    from a boundary counts as 0 there."""
    series: dict[tuple, list[int]] = {}
    for i, census in enumerate(history):
        for kind, sites in census.items():
            for site, n in sites.items():
                key = (kind, site)
                if key not in series:
                    series[key] = [0] * i
                series[key].append(n)
        for key, vals in series.items():
            if len(vals) <= i:
                vals.append(0)
    out: list[dict] = []
    for (kind, site), vals in sorted(series.items()):
        if any(b < a for a, b in zip(vals, vals[1:])):
            continue  # a dip: the resource is torn down sometimes
        growth = vals[-1] - vals[0]
        steps = sum(1 for a, b in zip(vals, vals[1:]) if b > a)
        if growth >= min_growth and steps >= min_steps:
            out.append({
                "kind": kind,
                "site": site,
                "start": vals[0],
                "end": vals[-1],
                "steps": steps,
                "boundaries": len(vals),
            })
    return out


# -- install / uninstall ----------------------------------------------------


def install(package_dir: str | None = None) -> ResWitness:
    """Monkeypatch the resource factories. Idempotent; returns the
    process-wide witness."""
    global _WITNESS
    if _WITNESS is not None and _WITNESS.installed:
        return _WITNESS
    if package_dir is None:
        package_dir = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
    w = _WITNESS or ResWitness(package_dir)
    # the (open, Thread.__init__, ThreadPoolExecutor.__init__) factories
    # this install displaces: the wrappers call through to them and
    # uninstall() puts them back
    w.displaced = (
        builtins.open, threading.Thread.__init__,
        ThreadPoolExecutor.__init__,
    )
    builtins.open = w._open
    threading.Thread.__init__ = (
        lambda self, *a, **kw: w._thread_init(self, *a, **kw)
    )
    ThreadPoolExecutor.__init__ = (
        lambda self, *a, **kw: w._executor_init(self, *a, **kw)
    )
    w.installed = True
    _WITNESS = w
    return w


def uninstall() -> None:
    """Put back the factories :func:`install` displaced (another
    witness's, or the interpreter's own). A no-op when not installed."""
    w = _WITNESS
    if w is None or not w.installed:
        return
    (builtins.open, threading.Thread.__init__,
     ThreadPoolExecutor.__init__) = w.displaced
    w.installed = False


def current() -> ResWitness | None:
    return _WITNESS


# -- pytest plugin hooks ----------------------------------------------------
# tests/conftest.py delegates here so a subprocess mini-conftest (the
# deliberately-leaky fixture run in tests/test_reswitness.py) exercises
# the exact same plugin code path as tier-1.


def note_boundary() -> None:
    if _WITNESS is not None:
        _WITNESS.note_boundary()


def session_check(session) -> None:
    """Session-end leak verdict: print the summary line, and FAIL the
    run (exitstatus=1) when any (kind, site) grew monotonically across
    test boundaries — naming the offending creation stacks."""
    w = _WITNESS
    if w is None:
        return
    leaks = w.leaks()
    boundaries = len(w.boundaries)
    sites = len(w.site_stacks)
    if not leaks:
        print(
            f"\nreswitness: {sites} creation site(s) tracked over "
            f"{boundaries} test boundaries, no monotonic "
            f"fd/thread/executor growth"
        )
        return
    lines = []
    for leak in leaks:
        lines.append(
            f"{leak['kind']} @ {w.short_site(leak['site'])}: "
            f"{leak['start']} -> {leak['end']} live across "
            f"{leak['boundaries']} boundaries "
            f"({leak['steps']} growth steps)\n"
            f"      created at: {leak['stack'] or '<no stack>'}"
        )
    print(
        f"\nreswitness FAILED: {len(leaks)} monotonically growing "
        f"resource site(s):\n  " + "\n  ".join(lines)
    )
    session.exitstatus = 1
