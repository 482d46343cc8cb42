"""A volume server's allocation answer and its heartbeat, on the CPU.

The port's ``/admin/assign_volume`` (``server/volume.py``) sends no
heartbeat of its own, where the reference's sends one before it answers:
it waits only until every pulse collected before the volume existed has
reached the master, and the heartbeat loop's next pulse reports the
volume, as upstream's ``AllocateVolume`` rpc answers once the volume
exists. The wait keeps a full pulse collected before the add from
undoing a grow's registration of the volume.

(a) With the heartbeat loop stopped, the master counts no heartbeat
    from the server across an allocation (the reference's server sends
    one), and a pulse collected after the add and held in flight does
    not hold the answer. Both fail at the parent, whose allocation sends
    a heartbeat behind the one in flight.
(b) A full pulse collected before the add, held in the master until the
    allocation waits on it (or the grow registered the volume), leaves
    the grown volumes registered and writable once the assign answers,
    and no second grow runs. Passes at the parent too.
(c) A volume allocated by hand reaches the master's layout at the next
    pulse: not before it with the loop stopped (the reference's master
    knows it at the answer), and through the running loop.
(d) The hops: an allocation's volume files and pulse wait; a needle
    write's local write, the replicas' lookup and each push.

The gates are ``threading.Event``s; joins and polls time out
generously, and no case measures time.
"""

import linecache
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.server.master import (  # noqa: E402
    MasterServer as RefMaster,
)
from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolume,
)
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.server.master import MasterServer  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.tracing import middleware  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402

JOIN_S = 60.0  # generous: a join that times out is the failure
IDLE_PULSE = 3600.0  # the heartbeat loop sleeps through the case


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


class HeartbeatGate:
    """Wraps a master's ``_apply_heartbeat``: counts the heartbeats from
    one server's port and, once armed, holds the next of them at the
    door (``entered`` set) until ``release``."""

    def __init__(self, master, port: int):
        self.port = port
        self.count = 0
        self.armed = False
        self.entered = threading.Event()
        self.release = threading.Event()
        self.volumes_held: list[int] = []
        self._apply = master._apply_heartbeat
        master._apply_heartbeat = self.apply

    def apply(self, hb):
        if hb.port == self.port:
            self.count += 1
            if self.armed:
                self.armed = False
                self.volumes_held = [v.id for v in hb.volumes]
                self.entered.set()
                assert self.release.wait(4 * JOIN_S), "gate never opened"
        return self._apply(hb)


def _knows(master, vid: int) -> bool:
    return any(vid in dn.volumes for dn in master.topo.data_nodes())


def _pair(tmp_path, master_cls, volume_cls, pulse=IDLE_PULSE, **vkw):
    m = master_cls(pulse_seconds=60.0)
    m.start()
    vs = volume_cls(m.url, [str(tmp_path)], pulse_seconds=pulse, **vkw)
    vs.start()  # its first heartbeat registers it
    return m, vs


def _stop(m, vs):
    vs.stop()
    m.stop()


# -- (a) no pulse of its own -------------------------------------------------


def test_allocation_sends_no_heartbeat_of_its_own(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, device="cpu")
    try:
        gate = HeartbeatGate(m, _port(vs.url))
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 3})
        assert gate.count == 0, "the allocation sent a heartbeat"
        assert vs.store.has_volume(3)
    finally:
        _stop(m, vs)


def test_reference_allocation_sends_a_heartbeat(tmp_path):
    """The reference's allocation, for contrast: one heartbeat."""
    m, vs = _pair(tmp_path, RefMaster, RefVolume)
    try:
        gate = HeartbeatGate(m, _port(vs.url))
        ref_http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 3})
        assert gate.count == 1
    finally:
        _stop(m, vs)


def test_pulse_collected_after_the_add_does_not_hold_the_answer(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, device="cpu")
    gate = HeartbeatGate(m, _port(vs.url))
    store = vs.store
    # the store's allocation entry point (the parent's handler calls
    # add_volume): once it returns, a pulse is collected and held at
    # the master before the handler goes on
    name = ("allocate_volume" if hasattr(store, "allocate_volume")
            else "add_volume")
    real = getattr(store, name)
    pulses: list = []

    def added_then_pulse(*a, **kw):
        out = real(*a, **kw)
        gate.armed = True
        pulses.append(_in_thread(vs.heartbeat_once))
        assert gate.entered.wait(JOIN_S), "the pulse never reached the master"
        return out

    setattr(store, name, added_then_pulse)
    try:
        alloc, answered = _in_thread(lambda: http.post_json(
            f"{vs.url}/admin/assign_volume", {"volume": 4}))
        alloc.join(JOIN_S)
        # the answer came while the pulse was still held at the master
        # (the parent's waits for it, or for its send to time out)
        held = alloc.is_alive() or not pulses[0][0].is_alive()
        # the pulse in flight was collected after the add
        assert gate.volumes_held == [4]
    finally:
        gate.release.set()
        for th, _out in pulses:
            th.join(JOIN_S)
        alloc.join(JOIN_S)
        _stop(m, vs)
    assert not held, "the pulse in flight held the allocation's answer"
    assert answered["value"] == {"ok": True}
    assert gate.count == 1  # the held pulse only


# -- (b) a stale full pulse does not undo the grow ---------------------------


def _waiting_on_a_pulse() -> bool:
    """Whether an allocation handler waits for a pulse: on a condition
    (the port) or on the heartbeat lock (the reference)."""
    for f in sys._current_frames().values():
        chain = []
        while f is not None:
            chain.append(f)
            f = f.f_back
        if "_h_assign_volume" not in {x.f_code.co_name for x in chain}:
            continue
        top = chain[0]
        if top.f_code.co_name == "wait":
            return True
        line = linecache.getline(top.f_code.co_filename, top.f_lineno)
        if top.f_code.co_name == "_h_assign_volume" and "_hb_lock" in line:
            return True
    return False


def test_stale_full_pulse_leaves_the_grown_volume(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, device="cpu")
    gate = HeartbeatGate(m, _port(vs.url))
    registered = threading.Event()
    on_register = m.vg._registered

    def note():
        registered.set()
        if on_register is not None:
            on_register()

    m.vg._registered = note
    grows = []
    grow = m.vg.automatic_grow_by_type

    def counted(*a, **kw):
        grows.append(a[0].collection)
        return grow(*a, **kw)

    m.vg.automatic_grow_by_type = counted
    try:
        # a full pulse of no volume, in flight at the master
        gate.armed = True
        pulse = _in_thread(vs.heartbeat_once)
        assert gate.entered.wait(JOIN_S)
        assert gate.volumes_held == []
        assigner, assigned = _in_thread(lambda: http.get_json(
            f"{m.url}/dir/assign?collection=g"))
        deadline = time.monotonic() + JOIN_S
        while not (registered.is_set() or _waiting_on_a_pulse()):
            assert time.monotonic() < deadline, "no allocation started"
            time.sleep(0.01)
        gate.release.set()
        pulse[0].join(JOIN_S)
        assigner.join(JOIN_S)
        assert not assigner.is_alive(), "the assign never answered"
        assert "fid" in assigned["value"], assigned
        vid = int(assigned["value"]["fid"].split(",")[0])
        assert _knows(m, vid)
        layout = m.topo.get_volume_layout(
            "g", vs.store.find_volume(vid).super_block.replica_placement,
            vs.store.find_volume(vid).ttl)
        assert layout.active_volume_count == len(
            [v for v in vs.store.locations[0].volumes.values()
             if v.collection == "g"]) > 0
        # a second assign finds the layout writable: no second grow
        again = http.get_json(f"{m.url}/dir/assign?collection=g")
        assert "fid" in again
        assert grows == ["g"]
    finally:
        gate.release.set()
        _stop(m, vs)


# -- (c) a hand allocation reaches the master at the next pulse --------------


def test_hand_allocation_reaches_the_master_at_the_next_pulse(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, device="cpu")
    try:
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 5})
        assert not _knows(m, 5)  # the deliberate difference
        vs.heartbeat_once()  # the next pulse
        assert _knows(m, 5)
        assert http.get_json(f"{m.url}/dir/lookup?volumeId=5")[
            "locations"][0]["url"] == vs.url.split("://")[-1]
    finally:
        _stop(m, vs)


def test_hand_allocation_reaches_the_master_through_the_loop(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, pulse=0.05,
                  device="cpu")
    try:
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 6})
        deadline = time.monotonic() + JOIN_S
        while not _knows(m, 6):
            assert time.monotonic() < deadline, "no pulse reported it"
            time.sleep(0.02)
    finally:
        _stop(m, vs)


def test_reference_master_knows_a_hand_allocation_at_the_answer(tmp_path):
    m, vs = _pair(tmp_path, RefMaster, RefVolume)
    try:
        ref_http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 5})
        assert _knows(m, 5)
    finally:
        _stop(m, vs)


# -- (d) the hops ------------------------------------------------------------


def test_allocation_hops_keys(tmp_path):
    m, vs = _pair(tmp_path, MasterServer, VolumeServer, device="cpu")
    try:
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 7})
        answers = middleware.slow_answers()[("volume", _port(vs.url))]
    finally:
        _stop(m, vs)
    [alloc] = [e for e in answers if e["op"] == "POST /admin/assign_volume"]
    [hops] = alloc["hops"]
    assert set(hops) == {"add_volume_s", "pulse_wait_s"}
    assert all(v >= 0.0 for v in hops.values())


def test_write_hops_time_the_write_apart_from_replication(tmp_path):
    with ClusterHarness(n_volume_servers=2, racks=["r1", "r1"],
                        device="cpu", root=str(tmp_path)) as c:
        a = http.get_json(f"{c.master.url}/dir/assign?replication=001")
        body = b"hops" * 1000
        out = http.request("POST", f"http://{a['url']}/{a['fid']}", body)
        answers = middleware.slow_answers()[("volume", _port(a["url"]))]
    writes = [e for e in answers if e["op"] == "write"
              and len(e.get("hops") or ()) > 1]
    assert writes, answers
    hops = writes[0]["hops"]
    assert set(hops[0]) == {"write_s"}
    assert set(hops[1]) == {"lookup_s"}
    [push] = hops[2:]
    assert set(push) == {"peer", "push_s"}
    assert push["peer"] != f"http://{a['url']}"
    assert all(v >= 0.0 for h in hops for k, v in h.items()
               if k.endswith("_s"))
    assert b'"size": 4000' in out or b'"size":4000' in out


def test_chip_smoke_reports_each_growing_assign():
    """``chip_smoke.ConvergeTap`` lists every assign it saw run a grow,
    each allocation beside the allocated server's own answers and hops,
    and prints a line for each."""
    import chip_smoke

    alloc = chip_smoke.ALLOCATION
    tap = chip_smoke.ConvergeTap()
    tap.polls, tap.unhealthy, tap.last = 3, 0, None
    tap.seen = {
        ("master", 9333): {
            ("t1", "assign"): {
                "op": "assign", "duration": 2.5, "status": 200,
                "trace_id": "t1", "keys_s": 1e-5,
                "grow": {"wait_s": 0.01, "allocations": [
                    {"url": "127.0.0.1:8080", "volume": 1, "seconds": 0.4},
                    {"url": "127.0.0.1:8081", "volume": 2,
                     "seconds": 0.3}]}},
            ("t2", "assign"): {"op": "assign", "duration": 0.2,
                               "status": 200, "trace_id": "t2",
                               "keys_s": 1e-5}},
        ("volume", 8080): {("t3", alloc): {
            "op": alloc, "duration": 0.39, "status": 200,
            "trace_id": "t3",
            "hops": [{"add_volume_s": 0.3, "pulse_wait_s": 0.09}]}},
    }
    [grow] = tap.grows()
    assert grow["master"] == "127.0.0.1:9333" and grow["seconds"] == 2.5
    assert grow["grow_wait_s"] == 0.01
    first, second = grow["allocations"]
    assert (first["volume"], first["seconds"]) == (1, 0.4)
    assert first["answers"] == [
        (0.39, [{"add_volume_s": 0.3, "pulse_wait_s": 0.09}])]
    assert second["answers"] == []
    lines: list[str] = []
    out = tap.report(lines.append, {"converged": True,
                                    "converge_seconds": 1.0})
    assert out["grows"] == [grow]
    assert any("growing assign at master@127.0.0.1:9333: 2.5 s" in line
               for line in lines)
    assert any("allocation volume 1 at 127.0.0.1:8080 0.4 s" in line
               and "pulse_wait_s" in line for line in lines)
