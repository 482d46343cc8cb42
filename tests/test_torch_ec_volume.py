"""The port's ``EcVolume`` against the reference's on the same shards:
needle reads with every shard, with lost shards reconstructed on the fly
(on the codec's plain version and on its native host route), through a
remote reader, and the journal, version and error contracts."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.storage import backend as ref_backend  # noqa: E402
from seaweedfs_tpu.storage import needle as ref_needle  # noqa: E402
from seaweedfs_tpu.storage.ec_volume import EcVolume as RefEcVolume  # noqa: E402
from seaweedfs_tpu.storage.ec_volume import ShardBits as RefShardBits  # noqa: E402
from seaweedfs_tpu.storage.volume import Volume  # noqa: E402
from seaweedfs_tpu_torch.ops import codec as codec_mod  # noqa: E402
from seaweedfs_tpu_torch.ops.codec import RSCodec  # noqa: E402
from seaweedfs_tpu_torch.storage import backend  # noqa: E402
from seaweedfs_tpu_torch.storage.ec_volume import (  # noqa: E402
    EcVolume,
    ShardBits,
)
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    encoder,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "1")
RNG = np.random.default_rng(33)
LOSSES = [(), (0, 1, 10, 13), (0, 5, 11, 13), (3,)]


def _fields(n):
    v = dict(vars(n))
    v["ttl"] = n.ttl.to_bytes()
    return v


def _encode(base):
    encoder.write_ec_files(base, device="cpu")
    encoder.write_sorted_file_from_idx(base)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """A version-3 volume written by the reference's ``Volume`` (needles
    with and without names and mime, one of 1.2 MiB that crosses a 1 MiB
    block, an overwrite and a delete), encoded."""
    d = tmp_path_factory.mktemp("made")
    v = Volume(str(d), "", 42)
    expect = {}
    for i in range(1, 41):
        n_bytes = 1_200_000 if i == 7 else 200 + i * 613
        n = ref_needle.Needle(cookie=0x1234 + i, id=i,
                              data=RNG.integers(0, 256, n_bytes,
                                                dtype=np.uint8).tobytes())
        if i % 2:
            n.set_name(f"f{i}.bin".encode())
        if i % 3 == 0:
            n.set_mime(b"image/png")
        v.write_needle(n)
        expect[i] = n.data
    over = ref_needle.Needle(cookie=1, id=5, data=b"overwritten" * 99)
    v.write_needle(over)
    expect[5] = over.data
    v.delete_needle(9)
    del expect[9]
    v.close()
    base = str(d / "42")
    _encode(base)
    return base, expect


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The vendored Go-written volume, encoded at production block
    sizes (its vendored shards use test-sized blocks)."""
    d = tmp_path_factory.mktemp("golden")
    for ext in (".dat", ".idx"):
        shutil.copy(GOLDEN + ext, str(d / "1") + ext)
    base = str(d / "1")
    _encode(base)
    return base


def _lost_copy(src_base, tmp_path, lost):
    d = tmp_path / "lost"
    d.mkdir()
    name = os.path.basename(src_base)
    for ext in [".ecx", ".vif"] + [C.to_ext(i) for i in range(14)]:
        if os.path.exists(src_base + ext) and ext not in {
                C.to_ext(s) for s in lost}:
            shutil.copy(src_base + ext, str(d / name) + ext)
    return str(d / name)


def _same_reads(base, vid, keys):
    ours = EcVolume(base, vid, device="cpu")
    ref = RefEcVolume(base, vid)
    try:
        assert ours.shard_ids == ref.shard_ids
        assert ours.version == ref.version
        for key in keys:
            got, want = ours.read_needle(key), ref.read_needle(key)
            assert _fields(got) == _fields(want), f"needle {key:x}"
        return ours.shard_ids
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("lost", LOSSES)
def test_reads_equal_reference_on_a_made_volume(made, tmp_path, lost):
    base, expect = made
    base = _lost_copy(base, tmp_path, lost)
    ids = _same_reads(base, 42, sorted(expect))
    assert ids == [i for i in range(14) if i not in lost]
    ev = EcVolume(base, 42, device="cpu")
    try:
        for key, data in expect.items():
            assert ev.read_needle(key).data == data
    finally:
        ev.close()


@pytest.mark.parametrize("lost", LOSSES)
def test_reads_equal_reference_on_the_golden_volume(golden, tmp_path, lost):
    base = _lost_copy(golden, tmp_path, lost)
    ev = EcVolume(base, 1, device="cpu")
    keys = [int(k) for k in ev._ecx_keys]
    ev.close()
    # every needle with an interval on a lost shard, and a sample of the
    # rest
    _same_reads(base, 1, keys[::7] + keys[1::7])


def test_host_route_reads_equal_reference(made, tmp_path, monkeypatch):
    """The native host route of the codec (what a ``cuda`` codec takes
    under its floor) serves the reconstructions."""
    base, expect = made
    base = _lost_copy(base, tmp_path, (0, 5, 11, 13))
    monkeypatch.setattr(codec_mod, "choose_route",
                        lambda backend, n, floor: "native")
    before = codec_mod.HOST_DISPATCHES.value
    _same_reads(base, 42, sorted(expect))
    assert codec_mod.HOST_DISPATCHES.value > before


def test_remote_read_serves_some_shards(made, tmp_path):
    base, expect = made
    src = base
    base = _lost_copy(src, tmp_path, (0, 1, 2, 3, 4, 10))
    asked = []

    def remote_read(sid, off, n):
        asked.append(sid)
        if sid in (1, 3, 10):  # reachable peers
            with open(src + C.to_ext(sid), "rb") as f:
                f.seek(off)
                return f.read(n)
        return None

    ours = EcVolume(base, 42, device="cpu")
    ref = RefEcVolume(base, 42)
    try:
        assert len(ours.shard_ids) == 8
        for key in sorted(expect):
            got = ours.read_needle(key, remote_read)
            want = ref.read_needle(key, remote_read)
            assert _fields(got) == _fields(want)
            assert got.data == expect[key]
        assert {1, 3, 10} <= set(asked) and {0, 2, 4} & set(asked)
    finally:
        ours.close()
        ref.close()


def test_fewer_than_ten_shards_raise(made, tmp_path):
    base, expect = made
    base = _lost_copy(base, tmp_path, (0, 1, 2, 3, 4))
    ours = EcVolume(base, 42, device="cpu")
    try:
        with pytest.raises(IOError):
            for key in sorted(expect):
                ours.read_needle(key)
        with pytest.raises(IOError):
            ours.read_needle(7, lambda sid, off, n: None)
    finally:
        ours.close()


def test_delete_journal_survives_a_reopen(made, tmp_path):
    base, expect = made
    base = _lost_copy(base, tmp_path, ())
    ev = EcVolume(base, 42, device="cpu")
    ev.delete_needle(2)
    with pytest.raises(KeyError):
        ev.read_needle(2)
    ev.close()
    with open(base + ".ecj", "rb") as f:
        assert f.read() == (2).to_bytes(8, "big")
    ev2 = EcVolume(base, 42, device="cpu")
    ref = RefEcVolume(base, 42)
    try:
        for e in (ev2, ref):
            with pytest.raises(KeyError):
                e.read_needle(2)  # journalled
            with pytest.raises(KeyError):
                e.read_needle(9)  # deleted before the encode: not in the .ecx
            with pytest.raises(KeyError):
                e.read_needle(10_000)  # never written
        assert ev2.read_needle(3).data == expect[3]
        assert ev2.find_needle_from_ecx(3) == ref.find_needle_from_ecx(3)
        got, want = ev2.locate_needle(7), ref.locate_needle(7)
        assert got[:2] == want[:2] and len(got[2]) == 2
        assert [vars(i) for i in got[2]] == [vars(i) for i in want[2]]
    finally:
        ev2.close()
        ref.close()


def test_version_from_vif_without_shard_zero(tmp_path):
    """A node holding shards 1-13 of a version-2 volume learns the
    version from the .vif."""
    d = tmp_path / "v2"
    d.mkdir()
    v = Volume(str(d), "", 5, version=2)
    expect = {}
    for i in range(1, 25):
        n = ref_needle.Needle(cookie=i, id=i, data=RNG.integers(
            0, 256, 700 * i, dtype=np.uint8).tobytes())
        n.set_name(f"v2-{i}".encode())
        v.write_needle(n)
        expect[i] = n.data
    v.close()
    base = str(d / "5")
    _encode(base)
    info = ref_backend.load_volume_info(base)
    backend.save_volume_info(base, {**info, "version": 2})
    assert backend.load_volume_info(base) == ref_backend.load_volume_info(
        base)
    os.remove(base + C.to_ext(0))
    ours = EcVolume(base, 5, device="cpu")
    try:
        assert ours.version == 2 == RefEcVolume(base, 5).version
        for key, data in expect.items():
            assert ours.read_needle(key).data == data
    finally:
        ours.close()
    _same_reads(base, 5, sorted(expect))


def test_offset_width_mismatch_raises(made, tmp_path):
    base, _ = made
    base = _lost_copy(base, tmp_path, ())
    backend.save_volume_info(base, {"offset_size": 5})
    assert backend.volume_offset_width(base) == 5
    with pytest.raises(RuntimeError, match="5-byte offsets"):
        EcVolume(base, 42, device="cpu")
    with pytest.raises(RuntimeError):
        RefEcVolume(base, 42)
    os.remove(base + ".vif")
    assert backend.volume_offset_width(base) == 4
    EcVolume(base, 42, device="cpu").close()


def test_shard_management_and_destroy(made, tmp_path):
    base, _ = made
    base = _lost_copy(base, tmp_path, (4,))
    ev = EcVolume(base, 42, device="cpu", shard_ids=[0, 1, 2, 4])
    assert ev.shard_ids == [0, 1, 2]
    assert ev.add_shard(3) and not ev.add_shard(3)
    ev.delete_shard(1)
    assert ev.shard_ids == [0, 2, 3]
    assert ev.shard_size == os.path.getsize(base + C.to_ext(0))
    ev.delete_needle(1)
    ev.destroy()
    assert not os.path.exists(base + C.to_ext(0))
    assert not os.path.exists(base + ".ecx")
    assert not os.path.exists(base + ".ecj")
    assert os.path.exists(base + C.to_ext(1))  # not mounted: kept


def test_shard_bits_match_reference():
    ops = [("add", 0), ("add", 13), ("add", 5), ("remove", 5), ("add", 9),
           ("add", 9)]
    ours, ref = ShardBits(), RefShardBits()
    for op, sid in ops:
        ours, ref = getattr(ours, op)(sid), getattr(ref, op)(sid)
        assert ours.bits == ref.bits and ours.ids() == ref.ids()
        assert ours.count() == ref.count()
    other = ShardBits().add(1).add(13)
    assert ours.plus(other).bits == ref.plus(RefShardBits(other.bits)).bits
    assert ours.minus(other).bits == ref.minus(RefShardBits(other.bits)).bits
    assert ours.has(0) and not ours.has(5)
    assert ours == ShardBits(ours.bits) and ours != ref
    assert repr(ours) == repr(ref)
    assert ShardBits(1 << 40).bits == 0


def test_no_card_raises_unless_asked_for_the_cpu(made):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base, _ = made
    with pytest.raises(RuntimeError):
        EcVolume(base, 42)
    with pytest.raises(RuntimeError):
        EcVolume(base, 42, device="cuda")
    EcVolume(base, 42, rs=RSCodec(device="cpu")).close()
