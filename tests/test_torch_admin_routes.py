"""The volume server's ``/admin/fsck``, ``/admin/tail`` with
``storage/volume_backup.py``, and the status pages of ``server/ui.py``
(``/ui`` on the volume server, ``/`` and ``/ui`` on the master), held
against the reference's on the CPU.

One request sequence goes to a volume server of each package (the
port's on ``device="cpu"``) under one pinned record clock: the same
statuses and bodies once server URLs are named by role. Each package's
``incremental_backup`` pulls from each package's server, first in full
and then the records written since, and the replica it builds replays
the source byte for byte.
"""

import http.client as http_client
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.server.master import MasterServer as RefMaster  # noqa: E402,E501
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume  # noqa: E402,E501
from seaweedfs_tpu.storage import volume_backup as ref_backup  # noqa: E402
from seaweedfs_tpu_torch.server.master import (  # noqa: E402
    MasterServer as PortMaster,
)
from seaweedfs_tpu_torch.server.volume import (  # noqa: E402
    VolumeServer as PortVolume,
)
from seaweedfs_tpu_torch.storage import volume_backup as port_backup  # noqa: E402,E501

torch.set_num_threads(2)

NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
TS = "1700000000"
PKGS = {"ref": (RefMaster, RefVolume, ref_backup),
        "port": (PortMaster, PortVolume, port_backup)}


def _call(url, method, path, body=None):
    """(status, body, X-Tail-Offset) of one request."""
    conn = http_client.HTTPConnection(url.split("//")[-1], timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("X-Tail-Offset")
    finally:
        conn.close()


def _server(which, root):
    V = PKGS[which][1]
    kw = {"device": "cpu"} if which == "port" else {}
    vs = V(NO_MASTER, [str(root)], pulse_seconds=60, **kw)
    vs.start()
    return vs


def _write(url, vid, keys, seed):
    rng = np.random.default_rng(seed)
    for key in keys:
        data = rng.integers(0, 256, int(rng.integers(1, 5000)),
                            dtype=np.uint8).tobytes()
        status, _, _ = _call(url, "POST",
                             f"/{vid},{key:x}{0x5eed0000 + key:08x}?ts={TS}",
                             data)
        assert status in (200, 201)


def _sequence(which, root, stamps):
    vs = _server(which, root)
    stamps.clear()
    try:
        u = vs.url
        seq = [_call(u, "POST", "/admin/assign_volume", b'{"volume": 3}')]
        _write(u, 3, range(1, 9), seed=1)
        _call(u, "DELETE", f"/3,{2:x}{0x5eed0002:08x}")
        seq.append(_call(u, "GET", "/admin/tail?volume=3"))
        # records appended at or after a stamp: the last two writes
        since = stamps[-3]
        seq.append(_call(u, "GET", f"/admin/tail?volume=3&since_ns={since}"))
        seq.append(_call(u, "GET",
                         f"/admin/tail?volume=3&since_ns={stamps[-1] + 1}"))
        seq.append(_call(u, "GET", "/admin/tail?volume=4"))
        seq.append(_call(u, "POST", "/admin/fsck", b"{}"))
        # one needle's data bytes flipped on disk: fsck names it
        dat = os.path.join(root, "3.dat")
        with open(dat, "r+b") as f:
            f.seek(8 + 16 + 4 + 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        seq.append(_call(u, "POST", "/admin/fsck", b"{}"))
        status, page, _ = _call(u, "GET", "/ui")
        seq.append((status, page.decode().replace(u, "<vs>").encode(),
                    None))
        return seq
    finally:
        vs.stop()


@pytest.fixture
def stamps(monkeypatch):
    """One clock for every record of both packages: each record gets
    the next stamp of a fixed series."""
    series = []

    def time_ns():
        series.append(1_700_000_000_000_000_000 + 1000 * len(series))
        return series[-1]

    monkeypatch.setattr(time, "time_ns", time_ns)
    return series


def test_tail_fsck_and_ui_match_reference(tmp_path, stamps):
    got = {which: _sequence(which, tmp_path / which, stamps)
           for which in PKGS}
    assert got["port"] == got["ref"]
    seq = got["port"]
    # (a volume the server does not hold: the reference answers 500)
    assert [s[0] for s in seq] == [200, 200, 200, 200, 500, 200, 200, 200]
    full, part, empty = seq[1], seq[2], seq[3]
    assert full[2] == "8" and len(full[1]) > 8 * 16
    assert part[1] == full[1][-len(part[1]):] and 0 < len(part[1]) < len(
        full[1])
    assert empty[1] == b"" and empty[2] is None
    assert json.loads(seq[5][1]) == {"checked": 7, "issues": []}
    doc = json.loads(seq[6][1])
    assert doc["checked"] == 7 and len(doc["issues"]) == 1
    assert doc["issues"][0].startswith("volume 3 needle 1: ")
    assert b"SeaweedFS-TPU Volume Server" in seq[7][1]


@pytest.mark.parametrize("server_kind", ["ref", "port"])
def test_incremental_backup_replays_byte_exact(server_kind, tmp_path,
                                               stamps):
    vs = _server(server_kind, tmp_path / "src")
    try:
        u = vs.url
        _call(u, "POST", "/admin/assign_volume",
              b'{"volume": 5, "collection": "bk"}')
        _write(u, 5, range(1, 6), seed=2)
        src = tmp_path / "src" / "bk_5"
        added = {}
        for which, (_m, _v, backup) in PKGS.items():
            d = tmp_path / which
            d.mkdir()
            added[which] = [backup.incremental_backup(str(d), "bk", 5, u),
                            backup.incremental_backup(str(d), "bk", 5, u)]
        _write(u, 5, range(6, 9), seed=3)
        _call(u, "DELETE", f"/5,{3:x}{0x5eed0003:08x}")
        for which, (_m, _v, backup) in PKGS.items():
            added[which].append(backup.incremental_backup(
                str(tmp_path / which), "bk", 5, u))
        assert added["port"] == added["ref"]
        first, none, more = added["port"]
        assert first == os.path.getsize(str(src) + ".dat") - more
        assert none == 0 and more > 0
        for which in PKGS:
            copy = tmp_path / which / "bk_5"
            assert (copy.with_suffix(".dat").read_bytes()
                    == src.with_suffix(".dat").read_bytes())
        # the replicas' indexes hold the same needles, found alike
        from seaweedfs_tpu_torch.storage.volume import Volume
        got = {}
        for which in PKGS:
            v = Volume(str(tmp_path / which), "bk", 5)
            try:
                got[which] = {k: v.read_needle(k).data
                              for k in range(1, 9) if k != 3}
                with pytest.raises(KeyError):
                    v.read_needle(3)
            finally:
                v.close()
        assert got["port"] == got["ref"] and len(got["port"]) == 7
    finally:
        vs.stop()


def test_master_status_page_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    pages = {}
    for which, (M, V, _b) in PKGS.items():
        m = M(pulse_seconds=0.2)
        m.start()
        kw = {"device": "cpu"} if which == "port" else {}
        vs = V(m.url, [str(tmp_path / which)], pulse_seconds=0.2, **kw)
        vs.start()
        try:
            deadline = time.time() + 10
            while not m.topo.data_nodes():
                assert time.time() < deadline
                time.sleep(0.02)
            for path in ("/", "/ui"):
                status, page, _ = _call(m.url, "GET", path)
                text = page.decode().replace(vs.url, "<vs>").replace(
                    m.url, "<master>")
                pages.setdefault(which, []).append((path, status, text))
        finally:
            vs.stop()
            m.stop()
    assert pages["port"] == pages["ref"]
    for _path, status, text in pages["port"]:
        assert status == 200 and "SeaweedFS-TPU Master" in text
        assert "<vs>/ui" in text
