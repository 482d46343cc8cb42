"""The port's needle and superblock formats against the reference's,
byte for byte, and chip_smoke's needle-volume generator read back by
the reference's ``Volume``."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.storage import (  # noqa: E402
    needle as ref_needle,
    super_block as ref_sb,
    types as ref_t,
)
from seaweedfs_tpu.storage.volume import Volume  # noqa: E402
from seaweedfs_tpu_torch.storage import (  # noqa: E402
    needle,
    super_block,
    types as t,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

RNG = np.random.default_rng(17)


def _pair(n_bytes, *, name=b"", mime=b"", ttl="", pairs=b"",
          last_modified=0, append_at_ns=0):
    """The same needle built in both packages."""
    data = RNG.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    cookie = int(RNG.integers(0, 1 << 32))
    nid = int(RNG.integers(1, 1 << 63))
    out = []
    for mod, types in ((needle, t), (ref_needle, ref_t)):
        n = mod.Needle(cookie=cookie, id=nid, data=data)
        if name:
            n.set_name(name)
        if mime:
            n.set_mime(mime)
        if ttl:
            n.set_ttl(types.TTL.parse(ttl))
        if pairs:
            n.set_pairs(pairs)
        if last_modified:
            n.set_last_modified(last_modified)
        n.append_at_ns = append_at_ns
        out.append(n)
    return out


CASES = [
    dict(n_bytes=0),
    dict(n_bytes=1),
    dict(n_bytes=1000, name=b"a.txt"),
    dict(n_bytes=4096, name=b"x" * 300, mime=b"image/png"),
    dict(n_bytes=77, ttl="3d", last_modified=1_700_000_123),
    dict(n_bytes=513, pairs=b'{"k":"v"}', mime=b"text/plain",
         append_at_ns=1_700_000_000_123_456_789),
    dict(n_bytes=65_537, name=b"big.bin", ttl="5w", pairs=b"{}",
         last_modified=1_234_567_890, append_at_ns=42),
]


def _fields(n):
    v = dict(vars(n))
    v["ttl"] = n.ttl.to_bytes()
    return v


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_needle_bytes_and_parse_match_reference(version, case):
    ours, ref = _pair(**CASES[case])
    rec = ours.to_bytes(version)
    assert rec == ref.to_bytes(version)
    assert len(rec) == needle.get_actual_size(ours.size, version)
    assert len(rec) % t.NEEDLE_PADDING_SIZE == 0
    for mod in (needle, ref_needle):
        assert mod.padding_length(ours.size, version) == (
            ref_needle.padding_length(ours.size, version))
    got = needle.Needle.parse_header(rec)
    body = rec[t.NEEDLE_HEADER_SIZE:
               t.NEEDLE_HEADER_SIZE
               + needle.needle_body_length(got.size, version)]
    got.parse_body(body, version)
    want = ref_needle.Needle.from_record(rec, version)
    assert _fields(got) == _fields(want)
    assert _fields(needle.Needle.from_record(rec, version)) == _fields(want)
    assert got.etag == want.etag


@pytest.mark.parametrize("version", [1, 2, 3])
def test_a_bad_crc_raises_checksum_error(version):
    ours, _ = _pair(300, name=b"n")
    rec = bytearray(ours.to_bytes(version))
    rec[t.NEEDLE_HEADER_SIZE + 7] ^= 0x40  # a data byte
    for mod in (needle, ref_needle):
        with pytest.raises(mod.ChecksumError):
            mod.Needle.from_record(bytes(rec), version)


def test_unknown_version_raises():
    ours, _ = _pair(10)
    with pytest.raises(ValueError):
        ours.to_bytes(4)


@pytest.mark.parametrize("kw", [
    {},
    dict(version=2, replica_placement="012", ttl="7d",
         compaction_revision=513),
    dict(version=1, replica_placement="200", ttl="", compaction_revision=3,
         extra=b"\x08\x01pb-extra"),
])
def test_super_block_round_trips_like_reference(kw):
    kw = dict(kw)
    rp, ttl = kw.pop("replica_placement", ""), kw.pop("ttl", "")
    ours = super_block.SuperBlock(**kw)
    ref = ref_sb.SuperBlock(**kw)
    if rp:
        ours.replica_placement = t.ReplicaPlacement.parse(rp)
        ref.replica_placement = ref_t.ReplicaPlacement.parse(rp)
    if ttl:
        ours.ttl, ref.ttl = t.TTL.parse(ttl), ref_t.TTL.parse(ttl)
    raw = ours.to_bytes()
    assert raw == ref.to_bytes()
    back = super_block.SuperBlock.from_bytes(raw)
    assert back.to_bytes() == raw
    assert back.block_size == ref_sb.SuperBlock.from_bytes(raw).block_size
    assert str(back.replica_placement) == str(ref.replica_placement)
    assert str(back.ttl) == str(ref.ttl)
    with pytest.raises(ValueError):
        super_block.SuperBlock.from_bytes(b"\x09" + raw[1:])
    with pytest.raises(ValueError):
        super_block.SuperBlock.from_bytes(raw[:5])


@pytest.mark.parametrize("s", ["", "3m", "4h", "5d", "6w", "7M", "8y", "15"])
def test_ttl_matches_reference(s):
    ours, ref = t.TTL.parse(s), ref_t.TTL.parse(s)
    assert ours.to_bytes() == ref.to_bytes()
    assert ours.to_uint32() == ref.to_uint32()
    assert ours.seconds == ref.seconds and str(ours) == str(ref)
    assert t.TTL.from_uint32(ref.to_uint32()).to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("size_mib,max_bytes,seed", [
    (3, 64 * 1024, 0),
    (6, 4 << 20, 1),
])
def test_generator_volume_reads_back_in_the_reference(tmp_path, size_mib,
                                                      max_bytes, seed):
    base = str(tmp_path / "7")
    live, deleted = chip_smoke.make_needle_volume(
        base, size_mib << 20, seed, max_bytes=max_bytes)
    assert live and os.path.getsize(base + ".dat") <= size_mib << 20
    v = Volume(str(tmp_path), "", 7)
    try:
        assert v.version == t.VERSION3
        for key, (i, n_bytes, name, mime) in live.items():
            n = v.read_needle(key)
            assert n.data == chip_smoke.needle_payload(seed, i, n_bytes)
            assert n.name == name and n.mime == mime
        for key in deleted:
            with pytest.raises(KeyError):
                v.read_needle(key)
    finally:
        v.close()


def test_generator_overwrites_and_deletes(tmp_path):
    base = str(tmp_path / "8")
    live, deleted = chip_smoke.make_needle_volume(
        base, 16 << 20, 3, max_bytes=16 * 1024)
    with open(base + ".idx", "rb") as f:
        log = f.read()
    entries = len(log) // t.NEEDLE_MAP_ENTRY_SIZE
    # the log holds one entry a record: new needles, overwrites, deletes
    assert deleted and entries > len(live) + len(deleted)
    assert not set(deleted) & set(live)
