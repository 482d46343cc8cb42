"""Reads and heartbeats across a volume's own swaps, on the CPU.

A volume server swaps or closes a volume's files while its readers and
its heartbeat still hold the volume: the vacuum commit swaps the
``(needle map, .dat)`` pair, an unmount or a delete closes it, a tier
move replaces the volume, an EC unmount closes a shard. Each case here
forces one such interleaving by a hook at the exact point between a
reader's lookup and its read, and checks that every read returns the
bytes written or the typed not-found, and that a heartbeat leaves a
closed volume out and its loop goes on.

The port serialises a read's lookup and ``pread`` with the swap; the
reference does not, and the same compact interleaving misparses there:
``test_compact_between_lookup_and_pread`` pins that difference. A
bounded stress case runs four readers against ten compact/commit
cycles with no wall-clock assertion.
"""

import struct
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.storage import needle as ref_needle  # noqa: E402
from seaweedfs_tpu.storage import volume as ref_volume  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.storage import needle as port_needle  # noqa: E402
from seaweedfs_tpu_torch.storage import volume as port_volume  # noqa: E402
from seaweedfs_tpu_torch.storage.ec_volume import EcVolume  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    encoder,
)
from seaweedfs_tpu_torch.storage.store import Store  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402

torch.set_num_threads(2)

SEED = 29
NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
# how long a hook waits for the swap it started: the swap ends at once
# where nothing holds it out, and waits for the read where the read
# holds the volume's read gate
SWAP_WAIT = 0.2
CYCLES = 10
PACKAGES = {"ref": (ref_volume, ref_needle),
            "port": (port_volume, port_needle)}


def _cookie(key):
    return 0x1234 + key


def _filled(vmod, nmod, directory, vid=1, n=200):
    """A volume of ``n`` seeded needles with every even key deleted;
    returns it and the live keys' bytes."""
    vol = vmod.Volume(str(directory), "", vid)
    rng = np.random.default_rng(SEED)
    data = {}
    for key in range(1, n + 1):
        size = int(rng.integers(100, 3000))
        body = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        vol.write_needle(nmod.Needle(cookie=_cookie(key), id=key,
                                     data=body))
        data[key] = body
    for key in range(2, n + 1, 2):
        vol.delete_needle(key)
        del data[key]
    return vol, data


def _read(read, key, data):
    """One read's outcome: "ok", "wrong bytes" or the exception's
    type."""
    try:
        got = read(key)
    except Exception as e:  # noqa: BLE001 - the outcome is the answer
        return type(e)
    return "ok" if got.data == data[key] else "wrong bytes"


def _hook_first_pread(vol, swap):
    """Make ``vol``'s next ``_pread`` start ``swap`` on another thread
    and give it ``SWAP_WAIT`` to finish before reading; returns the
    thread, to join."""
    orig = vol._pread
    started: list[threading.Thread] = []
    done = threading.Event()

    def run():
        swap()
        done.set()

    def hooked(offset, n):
        if not started:
            started.append(threading.Thread(target=run))
            started[0].start()
            done.wait(SWAP_WAIT)
        return orig(offset, n)

    vol._pread = hooked
    return started


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_compact_between_lookup_and_pread(tmp_path, pkg):
    """A ``commit_compact`` lands between a read's needle-map lookup and
    its ``pread``, ten cycles, one more needle deleted before each
    ``compact``. The port reads every needle right: the commit waits for
    the read. The reference reads the new ``.dat`` at the old offset and
    fails to parse every one."""
    vmod, nmod = PACKAGES[pkg]
    vol, data = _filled(vmod, nmod, tmp_path)
    live = sorted(data)
    outcomes = []
    try:
        for cycle in range(CYCLES):
            doomed = live.pop(0)
            vol.delete_needle(doomed)
            del data[doomed]
            vol.compact()
            key = live[(cycle * 7) % len(live)]
            started = _hook_first_pread(vol, vol.commit_compact)
            try:
                outcomes.append(_read(
                    lambda k: vol.read_needle(k, _cookie(k)), key, data))
            finally:
                started[0].join(60)
                del vol._pread
            assert not started[0].is_alive()
            assert vol.super_block.compaction_revision == cycle + 1
    finally:
        vol.close()
    if pkg == "port":
        assert outcomes == ["ok"] * CYCLES
    else:
        assert all(o in (struct.error, IndexError) for o in outcomes), (
            outcomes)


@pytest.mark.parametrize("when", ["mid-read", "before-read"])
def test_unmount_under_a_read(tmp_path, when):
    """``Store.unmount_volume`` closes a volume a reader already found:
    while its ``pread`` is under way (the read ends first, with the
    bytes written) or before its read starts (the volume raises the
    typed ``VolumeClosedError``, and the store's one retry answers the
    same not-found as for a volume never mounted). A read or a stat of
    the closed volume raises the typed error, and a second close is a
    no-op."""
    store = Store([str(tmp_path)], device="cpu")
    vol = store.add_volume(7)
    body = b"needle seven" * 50
    vol.write_needle(port_needle.Needle(cookie=_cookie(1), id=1,
                                        data=body))
    if when == "mid-read":
        started = _hook_first_pread(vol, lambda: store.unmount_volume(7))
        try:
            got = store.read_volume_needle(7, 1, _cookie(1))
        finally:
            started[0].join(60)
        assert not started[0].is_alive()
        assert got.data == body
    else:
        orig = vol.read_needle

        def closed_first(key, cookie=None):
            store.unmount_volume(7)
            return orig(key, cookie)

        vol.read_needle = closed_first
        with pytest.raises(KeyError, match="volume 7 not found"):
            store.read_volume_needle(7, 1, _cookie(1))
        del vol.read_needle
    assert store.find_volume(7) is None
    with pytest.raises(port_volume.VolumeClosedError):
        vol.read_needle(1, _cookie(1))
    with pytest.raises(port_volume.VolumeClosedError):
        vol.stat()
    vol.close()
    with pytest.raises(KeyError, match="volume 7 not found"):
        store.read_volume_needle(7, 1, _cookie(1))
    store.close()


def test_ec_shard_unmount_under_a_read(tmp_path):
    """An EC unmount closes the shard a read has just found: the read
    takes the shard as absent and reconstructs its interval from the
    others, with the bytes written."""
    vol, data = _filled(port_volume, port_needle, tmp_path, vid=3, n=60)
    vol.close()
    base = str(tmp_path / "3")
    encoder.write_ec_files(base, device="cpu")
    encoder.write_sorted_file_from_idx(base)
    ev = EcVolume(base, 3, device="cpu")
    unmounted = []
    for shard in list(ev.shards.values()):
        orig = shard.read_at

        def closed_first(offset, n, sid=shard.shard_id, orig=orig):
            if not unmounted:
                unmounted.append(sid)
                ev.delete_shard(sid)
            return orig(offset, n)

        shard.read_at = closed_first
    try:
        for key in sorted(data)[:5]:
            assert ev.read_needle(key).data == data[key]
    finally:
        ev.close()
    assert len(unmounted) == 1 and unmounted[0] not in ev.shards


class _TierStore(BaseHTTPRequestHandler):
    """A plain-HTTP tier: a POST keeps the body at its path, a GET
    answers it whole or one ``Range``."""

    blobs: dict = {}

    def do_POST(self):
        if self.headers.get("Transfer-Encoding") == "chunked":
            parts = []
            while size := int(self.rfile.readline().split(b";")[0], 16):
                parts.append(self.rfile.read(size))
                self.rfile.readline()
            self.rfile.readline()
            body = b"".join(parts)
        else:
            body = self.rfile.read(int(self.headers["Content-Length"]))
        self.blobs[self.path] = body
        self._answer(200, b"{}")

    def do_GET(self):
        blob = self.blobs.get(self.path)
        if blob is None:
            return self._answer(404, b"")
        rng = self.headers.get("Range")
        if rng:
            lo, hi = (int(x) for x in rng.split("=")[1].split("-"))
            return self._answer(206, blob[lo:hi + 1])
        self._answer(200, blob)

    def _answer(self, status, body):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args):
        pass


@pytest.fixture
def tier_store():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _TierStore)
    server.RequestHandlerClass.blobs = {}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


@pytest.mark.parametrize("moves", [("upload",), ("upload", "download")])
def test_tier_moves_between_lookup_and_read(tmp_path, tier_store, moves):
    """A started volume server answers a GET whose volume moved to the
    tier (and, in the second case, back) after the handler found it and
    before it read: the old volume is closed by then, the read looks the
    volume up once more, and the answer is the bytes written."""
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], pulse_seconds=60,
                      device="cpu")
    vs.start()
    try:
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 6})
        bodies = {k: bytes([k]) * (900 * k + 17) for k in range(1, 6)}
        fids = {k: f"6,{k:x}{_cookie(k):08x}" for k in bodies}
        for k, fid in fids.items():
            http.request("POST", f"{vs.url}/{fid}", bodies[k])
        old = vs.store.find_volume(6)
        orig = old.read_needle
        moved = []

        def moved_first(key, cookie=None):
            if not moved:
                for move in moves:
                    body = {"volume": 6}
                    if move == "upload":
                        body["dest_url"] = f"{tier_store}/tier/6.dat"
                    http.post_json(f"{vs.url}/admin/tier/{move}", body)
                    moved.append(move)
            return orig(key, cookie)

        old.read_needle = moved_first
        assert http.request("GET", f"{vs.url}/{fids[3]}") == bodies[3]
        assert moved == list(moves)
        new = vs.store.find_volume(6)
        assert new is not old and old.closed and not new.closed
        assert (new.remote_backend is not None) == (moves[-1] == "upload")
        for k, fid in fids.items():
            assert http.request("GET", f"{vs.url}/{fid}") == bodies[k]
    finally:
        vs.stop()


def test_heartbeat_leaves_out_a_closed_volume(tmp_path):
    """A volume closed under a pulse is left out of that heartbeat —
    never reported at size 0 — and the others are reported as before."""
    store = Store([str(tmp_path)], device="cpu")
    for vid in (1, 2):
        store.add_volume(vid).write_needle(
            port_needle.Needle(cookie=_cookie(vid), id=vid, data=b"x" * 99))
    store.collect_heartbeat()  # drains the new-volume deltas
    store.find_volume(1).close()
    hb = store.collect_heartbeat()
    assert [v.id for v in hb.volumes] == [2]
    assert hb.volumes[0].size > 0 and not hb.has_no_volumes
    store.close()
    assert store.collect_heartbeat().volumes == []


def test_heartbeat_loop_survives_a_bad_pulse(tmp_path):
    """``heartbeat_once`` with a volume closed under it goes through,
    and a pulse that raises is logged: the loop goes on to the next."""
    vs = VolumeServer(NO_MASTER, [str(tmp_path)], pulse_seconds=0.02,
                      device="cpu")
    pulses: list[list[int]] = []
    collect = vs.store.collect_heartbeat
    fail_next = threading.Event()

    def counted():
        if fail_next.is_set() and threading.current_thread() is (
                vs._hb_thread):
            fail_next.clear()
            pulses.append(["raised"])
            raise RuntimeError("one bad pulse")
        hb = collect()
        pulses.append([v.id for v in hb.volumes])
        return hb

    vs.store.collect_heartbeat = counted
    vs.start()
    try:
        for vid in (4, 5):
            http.post_json(f"{vs.url}/admin/assign_volume", {"volume": vid})
        vs.store.find_volume(4).close()
        vs.heartbeat_once()
        assert pulses[-1] == [5]
        fail_next.set()
        deadline = time.monotonic() + 60
        while (["raised"] not in pulses or pulses[-3:].count([5]) < 3) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        after = pulses[pulses.index(["raised"]) + 1:]
        assert len(after) >= 3 and all(p == [5] for p in after)
        assert vs._hb_thread.is_alive()
    finally:
        vs.stop()


def test_readers_against_compact_cycles(tmp_path):
    """Four reader threads against ten compact/commit cycles of one
    volume, writes and deletes between them: no read fails and every
    byte is the one written."""
    vol, data = _filled(port_volume, port_needle, tmp_path, n=120)
    keys = sorted(data)
    stop = threading.Event()
    errors: list = []
    reads = [0] * 4

    def reader(i):
        rnd = np.random.default_rng(SEED + i)
        while not stop.is_set():
            key = keys[int(rnd.integers(0, len(keys)))]
            outcome = _read(lambda k: vol.read_needle(k, _cookie(k)),
                            key, data)
            if outcome != "ok":
                errors.append((key, outcome))
            reads[i] += 1

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # hand the interpreter over often
    for th in threads:
        th.start()
    try:
        for cycle in range(CYCLES):
            # churn that each cycle's copy and its makeup diff carry
            vol.write_needle(port_needle.Needle(
                cookie=_cookie(1000 + cycle), id=1000 + cycle,
                data=bytes([cycle]) * 500))
            vol.compact()
            vol.write_needle(port_needle.Needle(
                cookie=_cookie(2000 + cycle), id=2000 + cycle,
                data=bytes([cycle]) * 700))
            vol.delete_needle(1000 + cycle)
            vol.commit_compact()
    finally:
        stop.set()
        for th in threads:
            th.join(60)
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert min(reads) > 0
    assert vol.super_block.compaction_revision == CYCLES
    for cycle in range(CYCLES):
        assert vol.read_needle(2000 + cycle).data == bytes([cycle]) * 700
    vol.close()


def test_closed_error_is_the_ports_own():
    """The typed error lives in the port's ``storage/volume.py`` and is
    not an ``OSError``/``ValueError`` a caller would take for I/O."""
    assert issubclass(port_volume.VolumeClosedError, RuntimeError)
    assert not issubclass(port_volume.VolumeClosedError,
                          (OSError, ValueError, KeyError))
    assert not hasattr(ref_volume, "VolumeClosedError")
