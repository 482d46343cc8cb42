"""The port's ``ec.decode`` files against the reference's, byte for byte:
``write_dat_file``, ``write_idx_file_from_ec_index`` (with an ``.ecj``),
``find_dat_file_size``, ``iterate_ecj_file`` and
``read_ec_volume_version``, on the vendored golden shards and on volumes
made here, encoded with small blocks."""

import os
import shutil
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.storage import needle as ref_needle  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    decoder as ref_decoder,
)
from seaweedfs_tpu.storage.volume import Volume  # noqa: E402
from seaweedfs_tpu_torch.storage import erasure_coding as ec  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    decoder,
    encoder,
    rebuild,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "1")
# the block sizes the golden shards were written with
GOLDEN_BLOCKS = dict(large_block_size=10_000, small_block_size=100)
RNG = np.random.default_rng(41)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _two_copies(src_base, tmp_path, exts):
    """The same files under two bases: one for each package."""
    bases = []
    for who in ("port", "ref"):
        d = tmp_path / who
        d.mkdir()
        base = str(d / os.path.basename(src_base))
        for ext in exts:
            if os.path.exists(src_base + ext):
                shutil.copy(src_base + ext, base + ext)
        bases.append(base)
    return bases


def _decode_both(port_base, ref_base, blocks, journal=()):
    for base in (port_base, ref_base):
        with open(base + ".ecj", "ab") as f:
            for key in journal:
                f.write(struct.pack(">Q", key))
    size = decoder.find_dat_file_size(port_base)
    assert size == ref_decoder.find_dat_file_size(ref_base)
    assert decoder.read_ec_volume_version(port_base) == (
        ref_decoder.read_ec_volume_version(ref_base))
    assert list(decoder.iterate_ecj_file(port_base)) == list(
        ref_decoder.iterate_ecj_file(ref_base)) == list(journal)
    assert decoder.write_dat_file(port_base, size, **blocks) == (
        port_base + ".dat")
    ref_decoder.write_dat_file(ref_base, size, **blocks)
    assert decoder.write_idx_file_from_ec_index(port_base) == (
        port_base + ".idx")
    ref_decoder.write_idx_file_from_ec_index(ref_base)
    for ext in (".dat", ".idx"):
        assert _read(port_base + ext) == _read(ref_base + ext), ext
    return size


@pytest.mark.parametrize("journal", [(), (0x2A, 7, 1 << 40)])
def test_golden_decode_matches_reference(tmp_path, journal):
    exts = [".ecx"] + [C.to_ext(i) for i in range(C.DATA_SHARDS)]
    port_base, ref_base = _two_copies(GOLDEN, tmp_path, exts)
    size = _decode_both(port_base, ref_base, GOLDEN_BLOCKS, journal)
    original = _read(GOLDEN + ".dat")
    assert 0 < size <= len(original)
    assert _read(port_base + ".dat") == original[:size]
    ecx = _read(GOLDEN + ".ecx")
    assert _read(port_base + ".idx") == ecx + b"".join(
        struct.pack(">QIi", key, 0, -1) for key in journal)


def _made_volume(d, n_needles, delete_last):
    v = Volume(str(d), "", 3)
    for i in range(1, n_needles + 1):
        n = ref_needle.Needle(cookie=i, id=i * 3 + 1, data=RNG.integers(
            0, 256, 90 + 37 * i, dtype=np.uint8).tobytes())
        if i % 4 == 0:
            n.set_name(f"n{i}".encode())
        v.write_needle(n)
    v.delete_needle(3 * 2 + 1)
    if delete_last:
        v.delete_needle(n_needles * 3 + 1)
    v.close()
    return str(d / "3")


@pytest.mark.parametrize("n_needles,blocks,delete_last", [
    (30, dict(large_block_size=1000, small_block_size=100), False),
    # small rows only: a live extent shorter than the .dat (the last
    # record a tombstone) keeps the encoder's row plan
    (30, dict(large_block_size=1 << 20, small_block_size=100), True),
    (120, dict(large_block_size=4096, small_block_size=64), False),
])
def test_made_volume_decode_matches_reference(tmp_path, n_needles, blocks,
                                              delete_last):
    (tmp_path / "src").mkdir()
    src = _made_volume(tmp_path / "src", n_needles, delete_last)
    encoder.write_ec_files(src, device="cpu", **blocks)
    encoder.write_sorted_file_from_idx(src)
    exts = [".ecx"] + [C.to_ext(i) for i in range(C.TOTAL_SHARDS)]
    port_base, ref_base = _two_copies(src, tmp_path, exts)
    # ec.decode makes the data shards whole first
    for sid in (0, 5, 11, 13):
        os.remove(port_base + C.to_ext(sid))
    assert rebuild.rebuild_ec_files(port_base, device="cpu") == [0, 5, 11,
                                                                  13]
    size = _decode_both(port_base, ref_base, blocks, journal=(4, 13))
    original = _read(src + ".dat")
    assert _read(port_base + ".dat") == original[:size]
    if delete_last:
        # the last record is a tombstone: the live extent ends before it
        assert size < len(original)


def test_find_dat_file_size_counts_journalled_deletes(tmp_path):
    """As in the reference: it reads the .ecx only, so a needle deleted
    after the encode (in the .ecj) still counts toward the extent."""
    src = str(tmp_path / "1")
    for ext in [".ecx", C.to_ext(0)]:
        shutil.copy(GOLDEN + ext, src + ext)
    before = decoder.find_dat_file_size(src)
    last = max(
        (int(k) for k in np.frombuffer(_read(src + ".ecx"), ">u8")[::2]),
        default=0)
    with open(src + ".ecj", "wb") as f:
        f.write(struct.pack(">Q", last))
    assert decoder.find_dat_file_size(src) == before == (
        ref_decoder.find_dat_file_size(src))


def test_decoder_is_exported():
    for name in ("write_dat_file", "iterate_ecj_file",
                 "write_idx_file_from_ec_index", "read_ec_volume_version",
                 "find_dat_file_size"):
        assert getattr(ec, name) is getattr(decoder, name)
