"""The port master's grow lock (``server/master.py``) on the CPU.

An assign takes the master's grow lock only when its layout has no
writable volume, and checks again inside it: upstream's
``dirAssignHandler`` (``weed/server/master_server_handlers.go:96-137``),
where the reference takes the lock on every assign. The grow runs
outside the lock and signals each volume it registers, so an assign
that waits on its layout's grow goes on with the first volume.

(a) While one layout's grow is held inside its allocator, an assign to
    another layout that has a writable volume answers.
(b) Eight concurrent assigns to an empty layout grow it once: 7
    volumes for replication ``000``.
(c) A serial sequence of assigns, a partial grow and ``/vol/grow`` on
    the same seeded topology answers the same from both packages'
    masters: volume ids, fid volume parts and keys, ``count``, ``url``,
    the statuses, and the number of grows and allocations.
(d) An assign that grew carries ``grow`` on its span: the seconds it
    waited for the lock and each allocation's server and seconds, as
    the server's window of slow answers (``tracing.middleware.slow_answers``)
    and ``/debug/slow`` show it, with every assign's sequencer seconds;
    a volume server's answer to an allocation carries its parts; an
    answer enters a server's window at the collect that counts it and
    leaves it 30 s later.
(e) An assign that waits on its layout's grow answers once the grow's
    first volume registers, while the grow's second allocation is
    held.

Masters here are not started unless a case needs HTTP: their handlers
are called directly, and the volume servers are heartbeats and a fake
allocator in place of the master's ``http`` module. The allocator's
gates are ``threading.Event``s; no case measures time.
"""

import json
import random
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.pb import messages as ref_messages  # noqa: E402
from seaweedfs_tpu.server import master as ref_master  # noqa: E402
from seaweedfs_tpu.topology import volume_layout as ref_layout  # noqa: E402
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu_torch.pb import messages as port_messages  # noqa: E402
from seaweedfs_tpu_torch.server import master as port_master  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.telemetry import slow as port_slow  # noqa: E402
from seaweedfs_tpu_torch.topology import (  # noqa: E402
    volume_layout as port_layout,
)
from seaweedfs_tpu_torch import tracing as port_tracing  # noqa: E402
from seaweedfs_tpu_torch.tracing import middleware  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402

SEED = 25
JOIN_S = 60.0  # generous: a join that times out is the failure

PKGS = {
    "ref": (ref_master, ref_layout, ref_messages, ref_http),
    "port": (port_master, port_layout, port_messages, port_http),
}


class FakeAllocator:
    """Stands in for the master's ``http`` module: records each
    ``/admin/assign_volume`` and, at the ``at``-th allocation (from 0)
    of the ``gated`` collection, sets ``entered`` and waits on
    ``release``."""

    def __init__(self, gated: str | None = None, at: int = 0):
        self.calls: list[tuple[str, int, str]] = []
        self.gated = gated
        self.at = at
        self.entered = threading.Event()
        self.release = threading.Event()
        self._lock = threading.Lock()

    def post_json(self, url, body, timeout=None):
        assert url.endswith("/admin/assign_volume"), url
        with self._lock:
            nth = sum(1 for _u, _v, c in self.calls
                      if c == body["collection"])
        if body["collection"] == self.gated and nth == self.at:
            self.entered.set()
            # longer than any join, so a join that times out fails first
            assert self.release.wait(4 * JOIN_S), "the gate never opened"
        with self._lock:
            self.calls.append((url.split("/admin")[0], body["volume"],
                               body["collection"]))
        return {}


def _master(name, monkeypatch, fake, nodes=3, slots=20, start=False):
    """A master of package `name` over `nodes` heartbeat-registered
    servers of `slots` slots each on one rack, its growth drawing from
    one seeded stream, its allocations going to `fake`."""
    master_mod, layout_mod, messages, _http = PKGS[name]
    rng = random.Random(SEED)
    monkeypatch.setattr(master_mod, "random", rng)
    monkeypatch.setattr(layout_mod, "random", rng)
    m = master_mod.MasterServer(pulse_seconds=60.0)
    m.vg._rng = random.Random(SEED)
    if start:
        m.start()
    monkeypatch.setattr(master_mod, "http", fake)
    for i in range(nodes):
        m._apply_heartbeat(messages.Heartbeat(
            ip="127.0.0.1", port=9001 + i, max_volume_count=slots,
            data_center="dc1", rack="r1", has_no_volumes=True))
    grows = []
    grow = m.vg.automatic_grow_by_type

    def counted(*a, **kw):
        grows.append(a[0].collection)
        return grow(*a, **kw)

    m.vg.automatic_grow_by_type = counted
    return m, grows


def _request(name, path, **params):
    http_mod = PKGS[name][3]
    return http_mod.Request("GET", path,
                            {k: [str(v)] for k, v in params.items()}, {})


def _assign(name, m, **params):
    resp = m._handle_assign(_request(name, "/dir/assign", **params))
    return resp.status, json.loads(resp.body)


def _port(url: str) -> int:
    return int(url.rsplit(":", 1)[1])


def _in_thread(fn):
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # surfaced by the test's assert
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, out


# -- (a) an assign to a writable layout never waits on a grow ----------------


def test_assign_to_writable_layout_does_not_wait_on_a_grow(monkeypatch):
    fake = FakeAllocator(gated="a")
    m, grows = _master("port", monkeypatch, fake)
    try:
        assert _assign("port", m, collection="b")[0] == 200
        grower, grown = _in_thread(
            lambda: _assign("port", m, collection="a"))
        assert fake.entered.wait(JOIN_S), "layout a's grow never started"
        other, answered = _in_thread(
            lambda: _assign("port", m, collection="b"))
        other.join(JOIN_S)
        # layout a's grow is still held in its allocator
        assert not fake.release.is_set()
        assert not other.is_alive(), (
            "an assign to layout b waited on layout a's grow")
        status, body = answered["value"]
        assert status == 200 and body["count"] == 1
        assert int(body["fid"].split(",")[0]) <= 7  # one of b's volumes
    finally:
        fake.release.set()
    grower.join(JOIN_S)
    assert not grower.is_alive()
    assert grown["value"][0] == 200
    assert grows == ["b", "a"]
    assert m.grow_waits() == {"assigns": 0, "seconds": 0.0, "max_s": 0.0}


# -- (b) concurrent assigns to an empty layout grow it once ------------------


def _waiting_in_assign(threads) -> int:
    """How many of `threads` are inside the master's assign handler
    without being in the allocator: each waits on a grow."""
    frames = sys._current_frames()
    n = 0
    for th, _out in threads:
        names = set()
        f = frames.get(th.ident)
        while f is not None:
            names.add(f.f_code.co_name)
            f = f.f_back
        if "_handle_assign" in names and "post_json" not in names:
            n += 1
    return n


def test_concurrent_assigns_grow_an_empty_layout_once(monkeypatch):
    n_assigns = 8
    fake = FakeAllocator(gated="c")
    m, grows = _master("port", monkeypatch, fake)
    threads = [_in_thread(lambda: _assign("port", m, collection="c"))
               for _ in range(n_assigns)]
    try:
        assert fake.entered.wait(JOIN_S), "no grow started"
        # every other assign is inside the handler while the grow's
        # first volume is held in its allocator
        deadline = time.monotonic() + JOIN_S
        while (_waiting_in_assign(threads) < n_assigns - 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert _waiting_in_assign(threads) == n_assigns - 1
    finally:
        fake.release.set()
    for th, _out in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    answers = [out["value"] for _th, out in threads]
    assert [status for status, _body in answers] == [200] * n_assigns
    assert grows == ["c"]
    assert len(fake.calls) == 7
    assert sorted(vid for _url, vid, _c in fake.calls) == list(range(1, 8))
    layout = m.topo.get_volume_layout(
        "c", port_master.t.ReplicaPlacement.parse("000"),
        port_master.t.TTL())
    assert layout.active_volume_count == 7
    vids = {int(body["fid"].split(",")[0]) for _s, body in answers}
    assert vids <= set(range(1, 8))


def test_assign_storm_grows_each_layout_once(monkeypatch):
    """More assigning threads than cores over four empty layouts, with
    the interpreter switching threads as often as it can: each layout
    is grown exactly once and every assign answers."""
    fake = FakeAllocator()
    m, grows = _master("port", monkeypatch, fake, nodes=4, slots=10)
    layouts = ["w", "x", "y", "z"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [_in_thread(lambda c=layouts[i % 4]: _assign(
            "port", m, collection=c)) for i in range(32)]
        for th, _out in threads:
            th.join(JOIN_S)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert [out["value"][0] for _th, out in threads] == [200] * 32
    assert sorted(grows) == layouts
    assert len(fake.calls) == 28
    assert len({vid for _u, vid, _c in fake.calls}) == 28


# -- (e) a waiter goes on with the first volume of its layout's grow ---------


def test_waiting_assign_goes_on_with_the_first_grown_volume(monkeypatch):
    first = threading.Event()
    fake = FakeAllocator(gated="c", at=1)  # hold the grow's 2nd volume
    m, grows = _master("port", monkeypatch, fake)
    post = fake.post_json
    waiters: list = []

    def held_first(url, body, timeout=None):
        # the first allocation waits until the second assign is inside
        # the handler, waiting on this grow
        if not first.is_set():
            first.set()
            deadline = time.monotonic() + JOIN_S
            while (not waiters or _waiting_in_assign(waiters) < 1) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        return post(url, body, timeout)

    fake.post_json = held_first
    grower = _in_thread(lambda: _assign("port", m, collection="c"))
    assert first.wait(JOIN_S), "no grow started"
    waiter = _in_thread(lambda: _assign("port", m, collection="c"))
    waiters.append(waiter)
    try:
        assert fake.entered.wait(JOIN_S), "the grow's 2nd volume not held"
        waiter[0].join(JOIN_S)
        assert not fake.release.is_set()
        assert not waiter[0].is_alive(), (
            "a waiting assign waited for the whole grow")
        status, body = waiter[1]["value"]
        assert status == 200 and body["fid"].startswith("1,")
    finally:
        fake.release.set()
    grower[0].join(JOIN_S)
    assert not grower[0].is_alive()
    assert grower[1]["value"][0] == 200
    assert grows == ["c"] and len(fake.calls) == 7
    waits = m.grow_waits()
    assert waits["assigns"] == 1 and waits["max_s"] > 0.0


# -- (c) a serial sequence answers as the reference's ------------------------


def _sequence(name, monkeypatch):
    fake = FakeAllocator()
    m, grows = _master(name, monkeypatch, fake, nodes=3, slots=6)
    out = []
    steps = [("assign", {}), ("assign", {}), ("assign", {"count": 3}),
             ("assign", {"collection": "pics"}),
             ("assign", {"collection": "pics", "count": 2}),
             ("assign", {}),
             # 18 slots: 14 taken, so this grow stops at 4 of 6
             ("grow", {"collection": "logs", "count": 6}),
             ("assign", {"collection": "logs"}),
             # nothing free: the grow fails and the assign answers 500
             ("assign", {"collection": "docs"}),
             ("assign", {"replication": "001", "collection": "pairs"}),
             ("assign", {"collection": "pics"})]
    for kind, params in steps:
        if kind == "assign":
            status, body = _assign(name, m, **params)
        else:
            resp = m._handle_grow(_request(name, "/vol/grow", **params))
            status, body = resp.status, json.loads(resp.body)
        if "fid" in body:
            vid, rest = body["fid"].split(",")
            body = dict(body, fid_volume=int(vid), fid_key=rest[:-8])
        out.append((kind, params, status, body))
    return out, grows, fake.calls


def test_serial_assigns_answer_as_the_reference(monkeypatch):
    got = {name: _sequence(name, monkeypatch) for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    seq, grows, calls = got["port"]
    assert grows == ["", "pics", "logs", "docs", "pairs"]
    assert len(calls) == 18
    statuses = [status for _k, _p, status, _b in seq]
    assert statuses == [200] * 8 + [500, 500, 200]
    partial = seq[6][3]
    assert partial["count"] == 4 and "error" in partial
    assert seq[2][3]["count"] == 3 and len(seq[2][3]["fids"]) == 3


# -- (d) the grow on the assign's span ---------------------------------------


def test_assign_span_carries_grow_wait_and_allocations(monkeypatch):
    ledger = port_slow.SlowLedger()
    monkeypatch.setattr(port_slow, "LEDGER", ledger)
    monkeypatch.setattr(middleware, "LEDGER", ledger)
    fake = FakeAllocator()
    m, grows = _master("port", monkeypatch, fake, start=True)
    try:
        first = port_http.get_json(f"{m.url}/dir/assign?collection=s")
        second = port_http.get_json(f"{m.url}/dir/assign?collection=s")
        answers = middleware.slow_answers()[("master", _port(m.url))]
        slow_doc = port_http.get_json(f"{m.url}/debug/slow")
    finally:
        m.stop()
    assert first["count"] == second["count"] == 1
    assert grows == ["s"]
    assigns = [e for e in answers if e["op"] == "assign"]
    assert len(assigns) == 2
    # only the assign that found the layout empty took the lock
    [grew] = [e for e in assigns if "grow" in e]
    grow = grew["grow"]
    assert grow["wait_s"] >= 0.0
    assert [a["url"] for a in grow["allocations"]] == [
        url for url, _vid, _c in fake.calls]
    assert [a["volume"] for a in grow["allocations"]] == list(range(1, 8))
    assert all(a["seconds"] >= 0.0 for a in grow["allocations"])
    assert grew["duration"] >= sum(a["seconds"]
                                   for a in grow["allocations"])
    ledger_assigns = [e for e in slow_doc["slow"] if e["op"] == "assign"]
    assert [e["grow"] for e in ledger_assigns if "grow" in e] == [grow]
    # every assign carries its sequencer's seconds
    assert all(e["keys_s"] >= 0.0 for e in assigns)
    # no other component answered on this master's port
    assert ("volume", _port(m.url)) not in middleware.slow_answers()


def test_allocation_answer_carries_its_hops(tmp_path):
    """A volume server's answer to a grow's allocation carries where it
    went: the volume's files and the wait for the pulse in flight (it
    sends no heartbeat of its own)."""
    vs = VolumeServer("http://127.0.0.1:9", [str(tmp_path)], device="cpu")
    vs.start()
    try:
        port_http.post_json(f"{vs.url}/admin/assign_volume",
                            {"volume": 3, "collection": "",
                             "replication": "000", "ttl": ""})
        answers = middleware.slow_answers()[("volume", _port(vs.url))]
    finally:
        vs.stop()
    [alloc] = [e for e in answers if e["op"] == "POST /admin/assign_volume"]
    [hops] = alloc["hops"]
    assert set(hops) == {"add_volume_s", "pulse_wait_s"}
    assert all(v >= 0.0 for v in hops.values())
    assert alloc["duration"] >= sum(hops.values())


def test_window_slow_counts_an_answer_from_its_collect():
    """An answer is pending until a collect counts it, then stays in
    the window for ``window_seconds`` from that collect; the fastest
    goes first when the window is full."""
    ws = port_slow.WindowSlow(capacity=3, window_seconds=30.0)

    def span(op, seconds, **attrs):
        sp = port_tracing.Span("master", op)
        sp.duration, sp.status = seconds, 200
        sp.attrs.update(attrs)
        return sp

    ws.offer_span(span("assign", 2.5, grow={"wait_s": 2.4,
                                            "allocations": []}))
    ws.offer_span(span("lookup", 0.01))
    now = time.monotonic()
    # pending before any collect, however old
    assert [e["op"] for e in ws.entries(now=now + 100.0)] == [
        "assign", "lookup"]
    ws.stamp(now + 50.0)
    assert [e["op"] for e in ws.entries(now=now + 79.0)] == [
        "assign", "lookup"]
    assert ws.entries(now=now + 81.0) == []
    [first] = ws.entries(limit=1, now=now + 60.0)
    assert first["grow"]["wait_s"] == 2.4 and first["duration"] == 2.5
    for i, d in enumerate((0.5, 0.7)):
        ws.offer_span(span(f"op{i}", d))
    assert [e["op"] for e in ws.entries(now=now + 60.0)] == [
        "assign", "op1", "op0"]
