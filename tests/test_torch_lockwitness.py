"""The port's runtime lock witness (``util/lockwitness.py``) held against
the reference's on the CPU.

Every case of the reference's ``tests/test_lockwitness.py`` runs on
isolated ``LockWitness`` instances of both packages (the same nestings,
the same snapshots, the same cycles and validation reports). Then the
two process-wide witnesses meet: the suite's conftest installs the
reference's before any package import, and installing and removing the
port's on top must leave ``threading.Lock``/``RLock``/``Condition``
exactly as they were, with neither witness recording the other
package's locks.
"""

import os
import threading

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.util import lockwitness as ref_lw  # noqa: E402
from seaweedfs_tpu_torch.util import lockwitness as port_lw  # noqa: E402

torch.set_num_threads(2)

PKGS = {"ref": ref_lw, "port": port_lw}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=sorted(PKGS))
def lw(request):
    return PKGS[request.param]


def _factories():
    return (threading.Lock, threading.RLock, threading.Condition)


@pytest.fixture
def port_global():
    """Leaves the port's process-wide witness, and threading's lock
    factories, exactly as the test found them."""
    before = _factories()
    prior = port_lw._WITNESS
    yield
    if port_lw._WITNESS is not None and port_lw._WITNESS.installed:
        port_lw.uninstall()
    port_lw._WITNESS = prior
    assert all(a is b for a, b in zip(_factories(), before))


def _wlock(lw, w, site):
    return lw._WLock(w, lw._REAL_LOCK(), site)


def _wrlock(lw, w, site):
    return lw._WRLock(w, lw._REAL_RLOCK(), site)


def _nest(lw, w, pairs):
    """Acquire each (outer, inner) pair nested, as the cases do."""
    for a, b in pairs:
        with a:
            with b:
                pass
    return w.snapshot()


class TestRecording:
    def test_nested_acquire_records_one_edge(self, lw):
        w = lw.LockWitness("/nonexistent")
        a, b = _wlock(lw, w, "f.py:1"), _wlock(lw, w, "f.py:2")
        snap = _nest(lw, w, [(a, b)] * 3)
        [edge] = snap["edges"]
        assert (edge["from"], edge["to"]) == ("f.py:1", "f.py:2")
        assert edge["count"] == 3
        assert edge["stack"]

    def test_no_edge_without_nesting(self, lw):
        w = lw.LockWitness("/nonexistent")
        a, b = _wlock(lw, w, "f.py:1"), _wlock(lw, w, "f.py:2")
        with a:
            pass
        with b:
            pass
        assert w.snapshot()["edges"] == []

    def test_rlock_reentry_adds_no_edge(self, lw):
        w = lw.LockWitness("/nonexistent")
        r = _wrlock(lw, w, "f.py:1")
        other = _wlock(lw, w, "f.py:2")
        with r:
            with r:
                with other:
                    pass
        assert [(e["from"], e["to"]) for e in w.snapshot()["edges"]] == [
            ("f.py:1", "f.py:2")]

    def test_same_site_nesting_tracked_separately(self, lw):
        w = lw.LockWitness("/nonexistent")
        v1, v2 = _wrlock(lw, w, "vol.py:64"), _wrlock(lw, w, "vol.py:64")
        snap = _nest(lw, w, [(v1, v2)])
        assert snap["edges"] == []
        assert snap["same_site"] == {"vol.py:64": 1}

    def test_edges_accumulate_across_threads(self, lw):
        w = lw.LockWitness("/nonexistent")
        a, b = _wlock(lw, w, "f.py:1"), _wlock(lw, w, "f.py:2")
        th = threading.Thread(target=_nest, args=(lw, w, [(a, b)]))
        th.start()
        th.join()
        _nest(lw, w, [(b, a)])
        assert {(e["from"], e["to"]) for e in w.snapshot()["edges"]} == {
            ("f.py:1", "f.py:2"), ("f.py:2", "f.py:1")}

    def test_condition_wait_releases_only_its_own_lock(self, lw):
        w = lw.LockWitness("/nonexistent")
        outer = _wlock(lw, w, "f.py:1")
        cond = lw._REAL_CONDITION(_wrlock(lw, w, "f.py:2"))
        with outer:
            with cond:
                cond.wait(timeout=0.01)
        [edge] = w.snapshot()["edges"]
        assert (edge["from"], edge["to"]) == ("f.py:1", "f.py:2")
        assert edge["count"] == 2


def test_both_witnesses_record_the_same_graph():
    """One nesting script through a witness of each package: the same
    snapshot, stacks aside."""
    snaps = {}
    for name, lw in PKGS.items():
        w = lw.LockWitness("/nonexistent")
        a, b = _wlock(lw, w, "f.py:1"), _wrlock(lw, w, "f.py:2")
        c, c2 = _wlock(lw, w, "g.py:9"), _wlock(lw, w, "g.py:9")
        _nest(lw, w, [(a, b), (b, c), (a, b), (c, c2)])
        with b:
            with b:
                pass
        snap = w.snapshot()
        for e in snap["edges"]:
            e.pop("stack")
        snaps[name] = snap
    assert snaps["port"] == snaps["ref"]


class TestCycles:
    CASES = [
        ([("A", "B"), ("B", "A")], [["A", "B"]]),
        ([("A", "B"), ("B", "C"), ("C", "A")], [["A", "B", "C"]]),
        ([("A", "B"), ("A", "C"), ("B", "C")], []),
        ([("A", "B"), ("B", "A"), ("C", "D"), ("D", "C"), ("B", "C"),
          ("E", "E")], [["C", "D"], ["A", "B"]]),
    ]

    @pytest.mark.parametrize("pairs,want", CASES)
    def test_find_cycles(self, lw, pairs, want):
        edges = [{"from": a, "to": b} for a, b in pairs]
        assert lw.find_cycles(edges) == want
        assert port_lw.find_cycles(edges) == ref_lw.find_cycles(edges)


class TestValidate:
    NAMES = {"/x/a.py:1": "A._lock", "/x/a.py:2": "B._lock"}

    @staticmethod
    def _snap(*pairs):
        return {
            "locks": {s: {"kind": "Lock", "created": 1}
                      for pair in pairs for s in pair},
            "edges": [{"from": a, "to": b, "count": 1, "stack": "s"}
                      for a, b in pairs],
            "same_site": {},
        }

    def _both(self, snap, site_name, may, wild):
        got = {name: lw.validate(snap, site_name, may, wild)
               for name, lw in PKGS.items()}
        assert got["port"] == got["ref"]
        return got["port"]

    def _name(self, p, line):
        return self.NAMES.get(f"{p}:{line}")

    def test_justified_edge_passes(self):
        report = self._both(self._snap(("/x/a.py:1", "/x/a.py:2")),
                            self._name, {("A._lock", "B._lock")}, set())
        assert report["missing"] == []
        assert report["edges"][0]["static"] == "edge"
        assert report["cycles"] == []

    def test_wildcard_holder_justifies(self):
        report = self._both(self._snap(("/x/a.py:1", "/x/a.py:2")),
                            self._name, set(), {"A._lock"})
        assert report["missing"] == []
        assert report["edges"][0]["static"] == "wildcard-holder"

    def test_unjustified_edge_is_a_hole(self):
        report = self._both(self._snap(("/x/a.py:1", "/x/a.py:2")),
                            self._name, set(), set())
        [m] = report["missing"]
        assert m["static"] == "MISSING"
        assert (m["from"], m["to"]) == ("A._lock", "B._lock")

    def test_unknown_creation_site_is_a_hole(self):
        report = self._both(self._snap(("/x/a.py:1", "/x/a.py:2")),
                            lambda p, l: None, set(), set())
        assert len(report["missing"]) == 1
        assert report["missing"][0]["static"] == "unknown-site"

    def test_dynamic_cycle_reported_on_names(self):
        report = self._both(
            self._snap(("/x/a.py:1", "/x/a.py:2"),
                       ("/x/a.py:2", "/x/a.py:1")),
            self._name,
            {("A._lock", "B._lock"), ("B._lock", "A._lock")}, set())
        assert report["cycles"] == [["A._lock", "B._lock"]]


class TestScope:
    def test_factory_wraps_only_package_frames(self, lw, tmp_path):
        w = lw.LockWitness(str(tmp_path))
        assert not isinstance(w._lock_factory(), lw._WLock)
        w2 = lw.LockWitness(os.path.dirname(os.path.abspath(__file__)))
        wrapped = w2._lock_factory()
        assert isinstance(wrapped, lw._WLock)
        site_path, _, line = wrapped._site.rpartition(":")
        assert site_path == os.path.abspath(__file__)
        assert int(line) > 0

    def test_port_scope_is_its_package_dir(self):
        pkg = os.path.join(REPO, "seaweedfs_tpu_torch") + os.sep
        w = port_lw.LockWitness(pkg[:-1])
        assert w.package_dir == pkg
        assert w._in_scope(os.path.join(pkg, "util", "x.py"))
        # the reference's package dir is a prefix of the port's name,
        # never of its path with the separator
        assert not w._in_scope(
            os.path.join(REPO, "seaweedfs_tpu", "util", "x.py"))
        ref = ref_lw.LockWitness(os.path.join(REPO, "seaweedfs_tpu"))
        assert not ref._in_scope(os.path.join(pkg, "util", "x.py"))

    def test_port_primitives_are_the_interpreters(self):
        import _thread

        assert port_lw._REAL_LOCK is _thread.allocate_lock
        assert port_lw._REAL_RLOCK is _thread.RLock
        assert isinstance(port_lw._REAL_CONDITION, type)
        assert port_lw._REAL_CONDITION.__module__ == "threading"
        assert port_lw._REAL_CONDITION.__name__ == "Condition"


class TestInstalled:
    def test_install_and_remove_restore_the_factories(self, port_global):
        """Whatever was installed before (the reference witness under
        this suite) is exactly what is installed after."""
        from seaweedfs_tpu.command.benchmark import KeySet as RefKeySet
        from seaweedfs_tpu_torch.command.benchmark import (
            KeySet as PortKeySet,
        )

        before = _factories()
        port_lw._WITNESS = None
        w = port_lw.install()
        assert w.installed and port_lw.current() is w
        assert threading.Lock == w._lock_factory
        assert port_lw.install() is w  # idempotent
        port_keys, ref_keys = PortKeySet(), RefKeySet()
        # a port lock is the port's wrapper over a raw interpreter lock
        assert isinstance(port_keys._lock, port_lw._WLock)
        assert type(port_keys._lock._inner) is type(port_lw._REAL_LOCK())
        assert not isinstance(port_keys._lock, ref_lw._WLock)
        # a reference lock created meanwhile is wrapped by neither
        assert not isinstance(ref_keys._lock, (port_lw._WLock,
                                               ref_lw._WLock))
        port_lw.uninstall()
        assert all(a is b for a, b in zip(_factories(), before))
        assert not w.installed
        port_lw.uninstall()  # a second removal changes nothing
        assert all(a is b for a, b in zip(_factories(), before))
        assert not any("seaweedfs_tpu" + os.sep in site
                       for site in w.snapshot()["locks"])

    def test_port_locks_never_reach_the_reference_witness(self):
        from seaweedfs_tpu_torch.command.benchmark import PhaseStats

        stats = PhaseStats("write")
        ref_w = ref_lw.current()
        if ref_w is None:
            assert type(stats._lock) is type(port_lw._REAL_LOCK())
            return
        assert not isinstance(stats._lock, ref_lw._WLock)
        assert not any("seaweedfs_tpu_torch" in site
                       for site in ref_w.snapshot()["locks"])

    def test_package_locks_wrapped_and_named(self, port_global):
        from tools.weedcheck import callgraph
        from tools.weedcheck.core import load_file

        port_lw._WITNESS = None
        w = port_lw.install()
        try:
            from seaweedfs_tpu_torch.command.benchmark import KeySet

            keys = KeySet()
        finally:
            port_lw.uninstall()
        assert isinstance(keys._lock, port_lw._WLock)
        src = os.path.join(REPO, "seaweedfs_tpu_torch", "command",
                           "benchmark.py")
        prog = callgraph.build_program([load_file(src)])
        path, _, line = keys._lock._site.rpartition(":")
        assert prog.site_name(path, int(line)) == "KeySet._lock"
        assert w.short_site(keys._lock._site).startswith(
            "command/benchmark.py:")

    def test_stdlib_locks_stay_raw(self, port_global):
        port_lw._WITNESS = None
        port_lw.install()
        try:
            q_lock = threading.Lock()
            ev = threading.Event()
        finally:
            port_lw.uninstall()
        assert not isinstance(q_lock, port_lw._WLock)
        assert not isinstance(getattr(ev._cond, "_lock", None),
                              port_lw._WLock)
