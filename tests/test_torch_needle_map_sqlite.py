"""The port's sqlite needle map (``storage/needle_map.SqliteNeedleMap``)
held against the reference's on the CPU.

One seeded put/delete/get sequence through each package's map gives
the same answers, the same metrics and the same ``.idx`` bytes, which
are also the memory map's. Reopening resumes from the watermark (and a
replaced ``.idx`` is rebuilt) in both alike. A ``Volume`` with
``needle_map_kind="sqlite"`` leaves the same ``.dat`` and ``.idx`` as
one with the memory map, and encodes to the same 14 shards and
``.ecx``; ``VolumeServer(needle_map_kind="sqlite")`` serves its needles.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.storage import needle_map as ref_nm  # noqa: E402
from seaweedfs_tpu.storage import types as ref_t  # noqa: E402
from seaweedfs_tpu_torch.storage import needle as port_needle  # noqa: E402
from seaweedfs_tpu_torch.storage import needle_map as port_nm  # noqa: E402
from seaweedfs_tpu_torch.storage import types as port_t  # noqa: E402
from seaweedfs_tpu_torch.storage import volume as port_volume  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    encoder as port_encoder,
)

torch.set_num_threads(2)

PACKAGES = {"ref": (ref_nm, ref_t), "port": (port_nm, port_t)}


def _sequence(nm, idx, seed):
    """A seeded mix of puts (some over live keys), deletes and gets;
    every answer the map gives, in order."""
    rng = np.random.default_rng(seed)
    m = nm.new_needle_map(idx, "sqlite")
    keys = [int(k) for k in rng.choice(1 << 40, 300, replace=False)]
    out = []
    for step in range(1500):
        k = keys[int(rng.integers(len(keys)))]
        op = rng.random()
        if op < 0.55:
            m.put(k, 8 * step, int(rng.integers(1, 5000)))
            out.append(("put", k))
        elif op < 0.75:
            out.append(("delete", k, m.delete(k, 8 * step)))
        else:
            v = m.get(k)
            out.append(("get", k, None if v is None else tuple(v)))
    met = m.metrics
    out.append(("metrics", met.file_count, met.deleted_count,
                met.deleted_bytes, met.file_bytes, met.maximum_key,
                m.content_size, len(m)))
    out.append(("visit", [(k, tuple(v)) for k, v in m.ascending_visit()]))
    out.append(("contains", [k in m for k in keys[:40]] + [1 << 41 in m]))
    m.close()
    return out


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_sqlite_sequence_matches_reference(tmp_path, seed):
    got, idx_bytes = {}, {}
    for name, (nm, _t) in PACKAGES.items():
        idx = str(tmp_path / f"{name}.idx")
        got[name] = _sequence(nm, idx, seed)
        with open(idx, "rb") as f:
            idx_bytes[name] = f.read()
    assert got["port"] == got["ref"]
    assert idx_bytes["port"] == idx_bytes["ref"]
    # the .idx is the memory map's too: replayed, both kinds agree
    mem = port_nm.new_needle_map(str(tmp_path / "port.idx"), "memory")
    sql = port_nm.new_needle_map(str(tmp_path / "port.idx"), "sqlite")
    assert list(mem.ascending_visit()) == list(sql.ascending_visit())
    assert mem.metrics.file_count == sql.metrics.file_count
    assert mem.metrics.deleted_bytes == sql.metrics.deleted_bytes
    mem.close()
    sql.close()
    assert isinstance(sql, port_nm.SqliteNeedleMap)


def _reopen(nm, t, idx, replace):
    m = nm.new_needle_map(idx, "sqlite")
    for k in range(200):
        m.put(k, k * 16, 64 + k % 7)
    m.delete(17, 0)
    m.close()
    if replace:  # a compaction's fresh .idx: the db must rebuild
        with open(idx, "wb") as f:
            for k in range(50, 60):
                f.write(t.pack_idx_entry(k, k * 32, 128))
    else:  # appended while the db was closed: replayed from the watermark
        with open(idx, "ab") as f:
            for k in range(200, 260):
                f.write(t.pack_idx_entry(k, k * 16, 64))
    m2 = nm.new_needle_map(idx, "sqlite")
    met = m2.metrics
    out = (len(m2), [None if m2.get(k) is None else tuple(m2.get(k))
                     for k in (3, 17, 55, 199, 259)],
           met.file_count, met.deleted_count, met.file_bytes,
           met.maximum_key)
    m2.close()
    return out


@pytest.mark.parametrize("replace", [False, True], ids=["resume", "replaced"])
def test_sqlite_reopen_matches_reference(tmp_path, replace):
    got = {name: _reopen(nm, t, str(tmp_path / f"{name}.idx"), replace)
           for name, (nm, t) in PACKAGES.items()}
    assert got["port"] == got["ref"]
    # a deleted key keeps its row (size negated), as in the reference
    assert got["port"][0] == (10 if replace else 260)


def _fill(d, kind, monkeypatch):
    """The same needles into a port volume with map ``kind``, under a
    pinned record clock."""
    ns = [1_700_000_000 * 10**9]

    def tick():
        ns[0] += 1_000_003
        return ns[0]

    monkeypatch.setattr(time, "time_ns", tick)
    os.makedirs(d)
    v = port_volume.Volume(d, "", 5, needle_map_kind=kind)
    rng = np.random.default_rng(5)
    for i in range(1, 400):
        n = port_needle.Needle(cookie=0x1234 + i, id=i,
                               data=rng.bytes(int(rng.integers(1, 9000))))
        v.write_needle(n)
    for i in range(3, 400, 11):
        v.delete_needle(i)
    v.write_needle(port_needle.Needle(cookie=9, id=7, data=b"rewritten"))
    reads = [v.read_needle(i).data for i in (1, 7, 200, 398)]
    v.close()
    return reads


def test_sqlite_volume_encodes_like_memory(tmp_path, monkeypatch):
    reads, files = {}, {}
    for kind in ("memory", "sqlite"):
        d = str(tmp_path / kind)
        reads[kind] = _fill(d, kind, monkeypatch)
        base = os.path.join(d, "5")
        port_encoder.write_ec_files(base, batch_bytes=1 << 20, device="cpu")
        port_encoder.write_sorted_file_from_idx(base)
        files[kind] = {}
        for ext in [".dat", ".idx", ".ecx"] + [C.to_ext(s) for s in
                                               range(C.TOTAL_SHARDS)]:
            with open(base + ext, "rb") as f:
                files[kind][ext] = f.read()
    assert reads["sqlite"] == reads["memory"]
    assert reads["sqlite"][1] == b"rewritten"
    assert files["sqlite"].keys() == files["memory"].keys()
    for ext, data in files["memory"].items():
        assert files["sqlite"][ext] == data, ext
    assert os.path.exists(str(tmp_path / "sqlite" / "5.idx.ldb"))
    # reloaded from disk, the sqlite volume serves the same needles
    v = port_volume.Volume(str(tmp_path / "sqlite"), "", 5,
                           needle_map_kind="sqlite")
    assert [v.read_needle(i).data for i in (1, 7, 200, 398)] == \
        reads["memory"]
    v.close()


def _serve(root, kind, monkeypatch):
    """Needles through a ``VolumeServer`` on map ``kind`` under a pinned
    record clock, then ``/admin/ec/generate``: its reads, shards and
    ``.ecx``."""
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.util import http

    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000 * 10**9)
    os.makedirs(root)
    vs = VolumeServer("127.0.0.1:9", [root], device="cpu",
                      needle_map_kind=kind)
    vs.start()
    try:
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 3})
        rng = np.random.default_rng(3)
        for i in range(1, 40):
            http.request("POST", f"{vs.url}/3,{i:x}00001234?ts=17",
                         rng.bytes(int(rng.integers(1, 20_000))))
        for i in (2, 9, 30):
            http.request("DELETE", f"{vs.url}/3,{i:x}00001234")
        reads = [http.request("GET", f"{vs.url}/3,{i:x}00001234")
                 for i in (1, 5, 39)]
        with pytest.raises(http.HttpError) as e:
            http.request("GET", f"{vs.url}/3,200001234")
        reads.append(e.value.status)
        vol = vs.store.find_volume(3)
        nm = (type(vol.nm).__name__, len(vol.nm),
              vol.nm.metrics.deleted_count)
        http.post_json(f"{vs.url}/admin/readonly", {"volume": 3})
        http.post_json(f"{vs.url}/admin/ec/generate", {"volume": 3})
    finally:
        vs.stop()
    files = {}
    for ext in [".dat", ".idx", ".ecx"] + [C.to_ext(s) for s in
                                           range(C.TOTAL_SHARDS)]:
        with open(os.path.join(root, "3" + ext), "rb") as f:
            files[ext] = f.read()
    return reads, nm, files


def test_volume_server_with_the_sqlite_map(tmp_path, monkeypatch):
    """``VolumeServer(needle_map_kind="sqlite")`` serves, deletes and
    encodes as the memory-map server does: the same reads, the same
    ``.dat`` and ``.idx``, the same 14 shards and ``.ecx``."""
    mem = _serve(str(tmp_path / "memory"), "memory", monkeypatch)
    sql = _serve(str(tmp_path / "sqlite"), "sqlite", monkeypatch)
    assert sql[0] == mem[0] and sql[0][-1] == 404
    assert sql[1] == ("SqliteNeedleMap", 39, 3)
    assert mem[1] == ("NeedleMap", 39, 3)
    assert sql[2].keys() == mem[2].keys()
    for ext, data in mem[2].items():
        assert sql[2][ext] == data, ext
