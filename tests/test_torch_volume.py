"""The port's volume engine — ``storage/{file_id,needle_map,volume,store}``
and the rest of ``backend`` — held against the reference on the CPU.

Every case of ``tests/test_volume.py`` runs once through each package,
on the same seeded inputs, in a directory of its own, under a clock the
test pins for both (``Volume`` stamps ``time.time_ns()`` into every
record): the answers, the exceptions and every file left behind
(``.dat``, ``.idx``, ``.vif``, shards, ``.ecx``, ``.ecj``) must be
identical, 0 differing bytes. Also the memory ``NeedleMap`` cases of
``tests/test_needle_map_sqlite.py``, ``collect_heartbeat`` key for key,
``new_needle_map(kind="sqlite")`` raising, and ``Store()`` raising
without a card."""

import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.storage import backend as ref_backend  # noqa: E402
from seaweedfs_tpu.storage import ec_volume as ref_ec  # noqa: E402
from seaweedfs_tpu.storage import file_id as ref_fid  # noqa: E402
from seaweedfs_tpu.storage import needle as ref_needle  # noqa: E402
from seaweedfs_tpu.storage import needle_map as ref_nm  # noqa: E402
from seaweedfs_tpu.storage import store as ref_store  # noqa: E402
from seaweedfs_tpu.storage import types as ref_t  # noqa: E402
from seaweedfs_tpu.storage import volume as ref_volume  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
)
from seaweedfs_tpu_torch.storage import backend as port_backend  # noqa: E402
from seaweedfs_tpu_torch.storage import ec_volume as port_ec  # noqa: E402
from seaweedfs_tpu_torch.storage import file_id as port_fid  # noqa: E402
from seaweedfs_tpu_torch.storage import needle as port_needle  # noqa: E402
from seaweedfs_tpu_torch.storage import needle_map as port_nm  # noqa: E402
from seaweedfs_tpu_torch.storage import store as port_store  # noqa: E402
from seaweedfs_tpu_torch.storage import types as port_t  # noqa: E402
from seaweedfs_tpu_torch.storage import volume as port_volume  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    encoder as port_encoder,
)

torch.set_num_threads(2)

SEED = 21

REF = types.SimpleNamespace(
    name="ref", needle=ref_needle, t=ref_t, volume=ref_volume,
    Volume=ref_volume.Volume, nm=ref_nm, fid=ref_fid,
    Store=ref_store.Store, EcVolume=ref_ec.EcVolume,
    ShardBits=ref_ec.ShardBits,
    encode=lambda base: ref_encoder.write_ec_files(base,
                                                   batch_bytes=1 << 20),
    sort=ref_encoder.write_sorted_file_from_idx, device={},
)
PORT = types.SimpleNamespace(
    name="port", needle=port_needle, t=port_t, volume=port_volume,
    Volume=port_volume.Volume, nm=port_nm, fid=port_fid,
    Store=port_store.Store, EcVolume=port_ec.EcVolume,
    ShardBits=port_ec.ShardBits,
    encode=lambda base: port_encoder.write_ec_files(
        base, batch_bytes=1 << 20, device="cpu"),
    sort=port_encoder.write_sorted_file_from_idx, device={"device": "cpu"},
)


CLOCK: list = []  # the running case's clock


class Clock:
    """``time.time_ns`` and ``time.time`` on a counter that restarts for
    each package's run, so both stamp the same values."""

    def __init__(self, monkeypatch):
        self.ns = 0
        CLOCK[:] = [self]
        monkeypatch.setattr(time, "time_ns", self._time_ns)
        monkeypatch.setattr(time, "time", lambda: self.ns / 1e9)

    def _time_ns(self) -> int:
        self.ns += 1_000_003
        return self.ns

    def reset(self) -> None:
        self.ns = 1_700_000_000 * 10**9


def _pin_mtime(path):
    """A volume loaded from disk reports its .dat's mtime as
    ``modified_at_second``: the file system's clock, one for both."""
    os.utime(path, (1_700_000_000, 1_700_000_000))


def _n(P, key, data=b"payload", cookie=0x1234):
    return P.needle.Needle(cookie=cookie, id=key, data=data)


def _err(fn, *a, **kw):
    """The call's result, or the name of what it raised."""
    try:
        return fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 - the name is the observation
        return f"raised {type(e).__name__}"


def _needle_view(n):
    return (n.id, n.cookie, n.data, n.name, n.mime, n.flags,
            n.last_modified, n.append_at_ns)


# -- the cases of tests/test_volume.py, one function a case --------------


def case_write_read_delete(P, d):
    v = P.Volume(d, "", 1)
    out = [v.write_needle(_n(P, 1, b"hello"))]
    out.append(_needle_view(v.read_needle(1)))
    out.append(_err(v.read_needle, 1, cookie=0x9999))
    out.append(v.delete_needle(1))
    out.append(_err(v.read_needle, 1))
    out.append(v.delete_needle(1))
    out.append(_err(v.read_needle, 77))
    v.close()
    return out


def case_reload_preserves_state(P, d):
    v = P.Volume(d, "col", 2)
    for i in range(1, 11):
        v.write_needle(_n(P, i, f"data{i}".encode()))
    v.delete_needle(3)
    v.close()
    v2 = P.Volume(d, "col", 2)
    out = [v2.read_needle(5).data, _err(v2.read_needle, 3),
           vars(v2.nm.metrics), vars(v2.stat()), v2.garbage_level()]
    v2.close()
    return out


def case_overwrite_dedupe_and_update(P, d):
    v = P.Volume(d, "", 3)
    out = [v.write_needle(_n(P, 7, b"same")),
           v.write_needle(_n(P, 7, b"same")),
           v.write_needle(_n(P, 7, b"changed")),
           v.read_needle(7).data, vars(v.nm.metrics)]
    v.close()
    return out


def case_readonly(P, d):
    v = P.Volume(d, "", 4, readonly=True)
    out = [_err(v.write_needle, _n(P, 1)), _err(v.delete_needle, 1)]
    v.close()
    return out


def case_vacuum_reclaims_space(P, d):
    v = P.Volume(d, "", 5)
    for i in range(1, 21):
        v.write_needle(_n(P, i, bytes(100)))
    for i in range(1, 11):
        v.delete_needle(i)
    out = [v.garbage_level(), v.data_file_size()]
    v.compact(bytes_per_second=10_000_000)
    v.commit_compact()
    out += [v.data_file_size(), v.garbage_level(),
            [v.read_needle(i).data for i in range(11, 21)],
            [_err(v.read_needle, i) for i in range(1, 11)],
            v.super_block.compaction_revision]
    v.close()
    return out


def case_vacuum_with_racing_write(P, d):
    v = P.Volume(d, "", 6)
    for i in range(1, 6):
        v.write_needle(_n(P, i, b"old"))
    v.delete_needle(1)
    v.compact()
    v.write_needle(_n(P, 100, b"racy"))
    v.delete_needle(2)
    v.write_needle(_n(P, 3, b"new3"))
    v.commit_compact()
    out = [v.read_needle(100).data, _err(v.read_needle, 2),
           v.read_needle(3).data, v.read_needle(4).data,
           vars(v.nm.metrics)]
    v.close()
    return out


def case_integrity_truncates_trailing_garbage(P, d):
    v = P.Volume(d, "", 8)
    v.write_needle(_n(P, 1, b"ok"))
    v.close()
    with open(os.path.join(d, "8.idx"), "ab") as f:
        f.write(P.t.pack_idx_entry(2, 1 << 20, 555))
    v2 = P.Volume(d, "", 8)
    out = [v2.nm.get(2), v2.read_needle(1).data]
    v2.close()
    return out


def case_binary_search_by_append_at_ns(P, d):
    v = P.Volume(d, "", 9)
    stamps = []
    for i in range(1, 6):
        v.write_needle(_n(P, i, b"x"))
        stamps.append(v.last_append_at_ns)
    off = v.binary_search_by_append_at_ns(stamps[2])
    out = [stamps, off, v._read_record_at(off).id,
           v.binary_search_by_append_at_ns(stamps[-1] + 10**9),
           v.data_file_size(), v.modified_at_second]
    v.close()
    return out


def case_ttl_and_replica_placement(P, d):
    v = P.Volume(d, "", 10, ttl=P.t.TTL.parse("3m"),
                 replica_placement=P.t.ReplicaPlacement.parse("010"))
    n = _n(P, 1, b"short-lived")
    n.set_last_modified(int(time.time()))
    out = [v.write_needle(n), v.read_needle(1).data,
           str(v.ttl), str(v.super_block.replica_placement)]
    CLOCK[0].ns += 181 * 10**9  # past the 3-minute TTL
    out.append(_err(v.read_needle, 1))
    v.set_replica_placement(P.t.ReplicaPlacement.parse("001"))
    v.close()
    v2 = P.Volume(d, "", 10)
    out.append(str(v2.super_block.replica_placement))
    v2.close()
    return out


def case_store_routing_and_heartbeat(P, d):
    store = P.Store([os.path.join(d, "a"), os.path.join(d, "b")], [2, 2],
                    port=8080, **P.device)
    store.add_volume(1)
    store.add_volume(2, collection="pics", replica_placement="001",
                     ttl="1d")
    store.write_volume_needle(1, _n(P, 10, b"one"))
    out = [store.read_volume_needle(1, 10).data,
           _err(store.add_volume, 1)]
    out.append(store.collect_heartbeat().to_dict())
    out.append(store.collect_heartbeat().to_dict())  # deltas drained
    store.mark_volume_readonly(2)
    out.append(_err(store.write_volume_needle, 2, _n(P, 1)))
    store.mark_volume_writable(2)
    store.unmount_volume(2)
    out.append(_err(store.unmount_volume, 2))
    for sub in ("a", "b"):
        if os.path.exists(os.path.join(d, sub, "pics_2.dat")):
            _pin_mtime(os.path.join(d, sub, "pics_2.dat"))
    store.mount_volume(2, "pics")
    store.delete_volume(1)
    out.append(_err(store.delete_volume, 1))
    out.append(store.collect_heartbeat().to_dict())
    store.close()
    return out


def case_store_reload(P, d):
    store = P.Store([os.path.join(d, "d")], [3], **P.device)
    store.add_volume(5, collection="c")
    store.write_volume_needle(5, _n(P, 1, b"persisted"))
    store.close()
    _pin_mtime(os.path.join(d, "d", "c_5.dat"))
    store2 = P.Store([os.path.join(d, "d")], [3], **P.device)
    out = [store2.read_volume_needle(5, 1).data,
           store2.collect_heartbeat().to_dict()]
    store2.close()
    return out


def _make_ec_volume(P, d, nneedles=20):
    rng = np.random.default_rng(SEED)
    v = P.Volume(d, "", 42)
    expect = {}
    for i in range(1, nneedles + 1):
        data = rng.integers(0, 256, size=200 + i * 13, dtype=np.uint8)
        v.write_needle(_n(P, i, data.tobytes()))
        expect[i] = data.tobytes()
    v.close()
    base = os.path.join(d, "42")
    _pin_mtime(base + ".dat")
    P.encode(base)
    P.sort(base)
    return base, expect


def case_ec_volume_local_reads(P, d):
    base, expect = _make_ec_volume(P, d)
    ev = P.EcVolume(base, 42, **P.device)
    out = [ev.shard_ids, [_needle_view(ev.read_needle(k)) for k in expect]]
    ev.close()
    return out


def case_ec_volume_reconstruct_on_read(P, d):
    base, expect = _make_ec_volume(P, d)
    for sid in (0, 1, 10, 13):
        os.remove(base + f".ec{sid:02d}")
    ev = P.EcVolume(base, 42, **P.device)
    out = [ev.shard_ids, [ev.read_needle(k).data for k in expect]]
    assert out[1] == list(expect.values())
    ev.close()
    return out


def case_ec_volume_delete_journal(P, d):
    base, expect = _make_ec_volume(P, d, 5)
    ev = P.EcVolume(base, 42, **P.device)
    ev.delete_needle(2)
    out = [_err(ev.read_needle, 2)]
    ev.close()
    ev2 = P.EcVolume(base, 42, **P.device)
    out += [_err(ev2.read_needle, 2), ev2.read_needle(3).data]
    ev2.close()
    return out


def case_store_ec_mount_unmount(P, d):
    _make_ec_volume(P, d)
    store = P.Store([d], [4], **P.device)
    out = [store.find_ec_volume(42) is not None]
    store.unmount_ec_shards(42, list(range(14)))
    out.append(store.find_ec_volume(42) is None)
    store.mount_ec_shards(42, "", [0, 1, 2])
    out.append(store.find_ec_volume(42).shard_ids)
    out.append(_err(store.mount_ec_shards, 43, "", [0]))
    out.append(store.collect_heartbeat().to_dict())
    store.close()
    return out


def case_shard_bits(P, d):
    b = P.ShardBits().add(0).add(13).add(5)
    return [b.ids(), b.count(), b.remove(5).ids(),
            b.plus(P.ShardBits().add(1)).count(),
            b.minus(P.ShardBits().add(0)).ids(), b.has(13), b.has(12),
            b == P.ShardBits(b.bits), repr(b), os.listdir(d)]


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _public(obs, tmp_path):
    """Observations with each package's own directory taken out."""
    return [o.replace(str(tmp_path), "<tmp>") if isinstance(o, str) else o
            for o in obs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path, monkeypatch):
    clock = Clock(monkeypatch)
    got = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        clock.reset()
        obs = CASES[case](P, str(d))
        got[P.name] = (_public(obs, d), _files(d))
    assert got["port"][0] == got["ref"][0]
    ref_files, port_files = got["ref"][1], got["port"][1]
    assert sorted(port_files) == sorted(ref_files)
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    assert ref_files or case == "shard_bits", \
        "the case left no files to compare"


@pytest.mark.parametrize("key,cookie,want", [
    (0x0163, 0x7037D6FF, "3,01637037d6ff"),
    (0, 0x12345678, "3,12345678"),
    (1 << 63, 1, "3,800000000000000000000001"),
])
def test_file_id_format(key, cookie, want):
    fid = port_fid.FileId(3, key, cookie)
    assert str(fid) == str(ref_fid.FileId(3, key, cookie)) == want
    assert port_fid.FileId.parse(want) == fid
    assert port_fid.parse_needle_id_cookie(want[2:] + "_9") == \
        ref_fid.parse_needle_id_cookie(want[2:] + "_9")
    for bad in ("3", ",0163", "3,0163"):
        with pytest.raises(ValueError):
            port_fid.FileId.parse(bad)


def _map_ops(nm, d, name):
    """The protocol and metrics cases of the sqlite map's tests, on the
    memory kind."""
    rng = np.random.default_rng(3)
    m = nm.new_needle_map(os.path.join(d, name + ".idx"), "memory")
    keys = rng.choice(100_000, size=500, replace=False)
    for i, k in enumerate(keys):
        m.put(int(k), i * 8, 100 + i)
    for k in keys[::7]:
        m.delete(int(k), 0)
    m.put(int(keys[1]), 9000, 77)  # an overwrite: garbage
    out = [[m.get(int(k)) for k in list(keys[:50]) + [999_999]], len(m),
           vars(m.metrics), m.content_size, list(m.ascending_visit()),
           int(keys[0]) in m]
    m.close()
    m2 = nm.new_needle_map(os.path.join(d, name + ".idx"), "memory")
    out += [vars(m2.metrics), len(m2)]
    m2.destroy()
    out.append(os.path.exists(os.path.join(d, name + ".idx")))
    return out


def test_needle_map_memory_kind(tmp_path):
    assert _map_ops(port_nm, tmp_path, "p") == _map_ops(ref_nm, tmp_path,
                                                        "r")


def test_sorted_file_needle_map(tmp_path):
    rng = np.random.default_rng(SEED)
    path = tmp_path / "v.ecx"
    keys = np.sort(rng.choice(1 << 40, 300, replace=False))
    with open(path, "wb") as f:
        for i, k in enumerate(keys):
            f.write(port_t.pack_idx_entry(int(k), 8 * (i + 1), 10 + i))
    ours, ref = port_nm.SortedFileNeedleMap(path), \
        ref_nm.SortedFileNeedleMap(path)
    probe = [int(k) for k in keys[::11]] + [0, 1 << 41]
    assert [ours.get(k) for k in probe] == [ref.get(k) for k in probe]
    assert len(ours) == len(ref) == 300


def test_sqlite_needle_map_waits(tmp_path):
    with pytest.raises(ValueError, match="not ported"):
        port_nm.new_needle_map(str(tmp_path / "a.idx"), "sqlite")
    with pytest.raises(ValueError, match="unknown"):
        port_nm.new_needle_map(str(tmp_path / "a.idx"), "bogus")


@pytest.mark.skipif("torch.cuda.is_available()")
def test_store_and_volume_engine_raise_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_store.Store([tmp_path / "s"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_store.DiskLocation(tmp_path / "l")
    with pytest.raises(RuntimeError):
        port_store.Store([tmp_path / "s"], device="cuda")


def test_store_codecs_take_the_store_options(tmp_path):
    _make_ec_volume(PORT, str(tmp_path))
    store = port_store.Store([tmp_path], [4], device="cpu",
                             device_min_bytes=12345, link_aware=False)
    ev = store.find_ec_volume(42)
    store.unmount_ec_shards(42, list(range(14)))
    store.mount_ec_shards(42, "", [0, 1])
    ev2 = store.find_ec_volume(42)
    for e in (ev, ev2):
        assert e.rs.device == torch.device("cpu")
        assert (e.rs.device_min_bytes, e.rs.link_aware) == (12345, False)
    assert ev.rs is not ev2.rs  # a codec an EcVolume
    store.close()


def test_backend_remote_tier(tmp_path):
    from seaweedfs_tpu_torch.util import http as port_http

    assert isinstance(port_backend.remote_backend_from_vif(
        {"url": "h:1/x", "size": 5}), port_backend.HttpRangeBackend)
    with pytest.raises(NotImplementedError, match="S3"):
        port_backend.remote_backend_from_vif(
            {"type": "s3", "bucket": "b", "key": "k"})
    # a tiered volume serves reads through Range requests
    src = tmp_path / "src"
    src.mkdir()
    v = port_volume.Volume(src, "", 7)
    v.write_needle(_n(PORT, 1, b"remote bytes"))
    v.close()
    dat = (src / "7.dat").read_bytes()
    h = port_http
    router = h.Router()

    def ranged(req):
        lo, hi = req.headers["Range"][6:].split("-")
        return h.Response(status=206, body=dat[int(lo):int(hi) + 1])

    router.add("GET", r"/7\.dat", ranged)
    srv = h.HttpServer(router)
    srv.start()
    try:
        tier = tmp_path / "tier"
        tier.mkdir()
        (tier / "7.idx").write_bytes((src / "7.idx").read_bytes())
        info = port_backend.load_volume_info(str(src / "7"))
        info["remote"] = {"url": f"{srv.url}/7.dat", "size": len(dat)}
        port_backend.save_volume_info(str(tier / "7"), info)
        rv = port_volume.Volume(tier, "", 7)
        assert rv.readonly and rv.read_needle(1).data == b"remote bytes"
        assert rv.data_file_size() == len(dat)
        rv.close()
        assert ref_backend.load_volume_info(str(tier / "7")) == info
    finally:
        srv.stop()
    disk = port_backend.DiskFile(str(src / "7.dat"))
    assert disk.read_at(0, 8) == dat[:8] and disk.size() == len(dat)
    disk.close()
