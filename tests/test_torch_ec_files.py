"""The port's EC file pipeline: ``.dat`` → ``.ec00–.ec13`` + ``.ecx``, and
rebuild, byte-identical to the golden shards and to the reference
package on the same payloads. Shards written by either package must
rebuild under the other.
"""

import os
import shutil
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
    rebuild as ref_rebuild,
)
from seaweedfs_tpu.telemetry import devices as ref_devices  # noqa: E402
from seaweedfs_tpu.telemetry import phases as ref_phases  # noqa: E402
from seaweedfs_tpu_torch.ops.codec import RSCodec  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    encoder,
    layout,
    rebuild,
)
from seaweedfs_tpu_torch.telemetry import devices  # noqa: E402
from seaweedfs_tpu_torch.telemetry.phases import PhaseTimer  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "1")
# the reference's scaled block sizes for its fixture volume (ec_test.go)
LARGE, SMALL = 10_000, 100


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def payload(size: int) -> bytes:
    rng = np.random.default_rng(zlib.crc32(repr(size).encode()))
    return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


@pytest.fixture()
def golden_encoded(tmp_path):
    base = str(tmp_path / "1")
    shutil.copy(GOLDEN + ".dat", base + ".dat")
    shutil.copy(GOLDEN + ".idx", base + ".idx")
    pt = PhaseTimer("ec.encode")
    encoder.write_ec_files(
        base, large_block_size=LARGE, small_block_size=SMALL,
        batch_bytes=4096, phases=pt, device="cpu",
    )
    encoder.write_sorted_file_from_idx(base)
    return base, pt.summary()


def test_golden_shards_and_ecx(golden_encoded):
    base, summary = golden_encoded
    for i in range(C.TOTAL_SHARDS):
        ext = C.to_ext(i)
        assert read(base + ext) == read(GOLDEN + ext), f"{ext} differs"
    assert read(base + ".ecx") == read(GOLDEN + ".ecx")
    phases = summary["phases"]
    for name in ("read", "stage", "h2d", "codec", "write", "flush"):
        assert name in phases, name
    assert phases["read"]["bytes"] == os.path.getsize(GOLDEN + ".dat")
    assert summary["notes"] == {"batch_bytes": 4096, "pipeline_depth": 3}


def test_golden_rebuild(golden_encoded):
    base, _ = golden_encoded
    for sid in (0, 5, 11, 13):
        os.remove(base + C.to_ext(sid))
    assert rebuild.rebuild_ec_files(base, device="cpu") == [0, 5, 11, 13]
    for i in range(C.TOTAL_SHARDS):
        ext = C.to_ext(i)
        assert read(base + ext) == read(GOLDEN + ext), f"rebuilt {ext}"
    assert rebuild.rebuild_ec_files(base, device="cpu") == []


# 100_000 = k*large exactly: the one size where a `>` vs `>=` drift in
# the striping loop changes byte layout while all roundtrips stay green
@pytest.mark.parametrize(
    "size", [1, 999, 1000, 1001, 99_999, 100_000, 100_001, 123_457]
)
def test_odd_sizes_match_reference(tmp_path, size):
    base_port = str(tmp_path / "port" / "9")
    base_ref = str(tmp_path / "ref" / "9")
    data = payload(size)
    for b in (base_port, base_ref):
        os.makedirs(os.path.dirname(b))
        with open(b + ".dat", "wb") as f:
            f.write(data)
    encoder.write_ec_files(
        base_port, large_block_size=LARGE, small_block_size=SMALL,
        batch_bytes=8192, device="cpu",
    )
    ref_encoder.write_ec_files(
        base_ref, large_block_size=LARGE, small_block_size=SMALL,
        batch_bytes=8192,
    )
    want_size = layout.shard_file_size(size, LARGE, SMALL)
    for i in range(C.TOTAL_SHARDS):
        ext = C.to_ext(i)
        got = read(base_port + ext)
        assert len(got) == want_size
        assert got == read(base_ref + ext), f"{ext} at size={size}"


def _encoded_pair(tmp_path, size):
    base_port = str(tmp_path / "port" / "7")
    base_ref = str(tmp_path / "ref" / "7")
    data = payload(size)
    for b in (base_port, base_ref):
        os.makedirs(os.path.dirname(b))
        with open(b + ".dat", "wb") as f:
            f.write(data)
    encoder.write_ec_files(
        base_port, large_block_size=LARGE, small_block_size=SMALL,
        batch_bytes=4096, device="cpu",
    )
    ref_encoder.write_ec_files(
        base_ref, large_block_size=LARGE, small_block_size=SMALL,
        batch_bytes=4096,
    )
    originals = {i: read(base_ref + C.to_ext(i)) for i in range(14)}
    return base_port, base_ref, originals


@pytest.mark.parametrize("lost", [(3,), (0, 5, 11, 13)])
def test_each_package_rebuilds_the_others_shards(tmp_path, lost):
    base_port, base_ref, originals = _encoded_pair(tmp_path, 123_457)
    for sid in lost:
        os.remove(base_port + C.to_ext(sid))
        os.remove(base_ref + C.to_ext(sid))
    # reference-written survivors rebuilt by the port, and vice versa
    assert rebuild.rebuild_ec_files(
        base_ref, device="cpu", window_bytes=4096
    ) == list(lost)
    assert ref_rebuild.rebuild_ec_files(
        base_port, window_bytes=4096
    ) == list(lost)
    for sid in lost:
        ext = C.to_ext(sid)
        assert read(base_ref + ext) == originals[sid]
        assert read(base_port + ext) == originals[sid]


def test_rebuild_needs_k_shards(tmp_path):
    base_port, _, _ = _encoded_pair(tmp_path, 5000)
    for sid in range(5):
        os.remove(base_port + C.to_ext(sid))
    with pytest.raises(ValueError):
        rebuild.rebuild_ec_files(base_port, device="cpu")


def test_injected_codec_and_dirty_ring(tmp_path):
    """A slab recycled by the ring holds the previous chunk's bytes: the
    EOF padding of a later chunk must still come out as zeros. A ring of
    one slab forces reuse on every chunk."""
    base = str(tmp_path / "5")
    with open(base + ".dat", "wb") as f:
        f.write(payload(31_337))
    rs = RSCodec(10, 4, device="cpu")
    rows = layout.encode_row_plan(31_337, LARGE, SMALL)
    ring = encoder._SlabRing(1, (10, 4096), rs.host_zeros)
    slab = ring.acquire()
    assert ring.take_pristine(slab) and not slab.any()
    slab[:] = 0xAB  # a previous chunk's bytes
    ring.release(slab)
    dat_bytes = read(base + ".dat")
    with open(base + ".dat", "rb") as dat:
        for start, bs in rows[-2:]:
            s = ring.acquire()
            assert not ring.take_pristine(s)
            out = encoder._read_row_chunk(dat, start, bs, 0, bs, 10, s[:, :bs])
            want = np.zeros(10 * bs, np.uint8)
            got = dat_bytes[start:start + 10 * bs]
            want[:len(got)] = np.frombuffer(got, np.uint8)
            np.testing.assert_array_equal(out.reshape(-1), want)
            ring.release(s)
    encoder.write_ec_files(base, rs=rs, large_block_size=LARGE,
                           small_block_size=SMALL, batch_bytes=4096)
    assert rs.verify(np.stack([
        np.frombuffer(read(base + C.to_ext(i)), np.uint8) for i in range(14)
    ]))


def test_choose_pipeline_cold_link():
    assert encoder.choose_pipeline(1 << 30) == (8 << 20, 3)
    assert encoder.choose_pipeline(5000) == (1 << 20, 3)
    assert encoder.choose_pipeline(1 << 30, batch_bytes=4096) == (4096, 3)
    ref_default = ref_encoder.DEFAULT_BATCH_BYTES
    assert encoder.DEFAULT_BATCH_BYTES == ref_default


def test_entry_points_raise_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base = str(tmp_path / "3")
    with open(base + ".dat", "wb") as f:
        f.write(payload(100))
    with pytest.raises(RuntimeError):
        encoder.write_ec_files(base)
    with pytest.raises(RuntimeError):
        rebuild.rebuild_ec_files(base)
    assert not os.path.exists(base + C.to_ext(0))


def test_staging_lane_and_phases_match_reference(tmp_path):
    """One volume through each package's ``write_ec_files``: the port's
    staging-lane row (lane 0) has the reference's chunk and byte counts,
    and the phase summaries the same phases, counts, bytes and notes."""
    size = 123_457
    bases = {}
    for side in ("port", "ref"):
        bases[side] = str(tmp_path / side / "7")
        os.makedirs(os.path.dirname(bases[side]))
        with open(bases[side] + ".dat", "wb") as f:
            f.write(payload(size))
    blocks = dict(large_block_size=LARGE, small_block_size=SMALL,
                  batch_bytes=4096)
    base, ref_base = devices.LEDGER.baseline(), ref_devices.LEDGER.baseline()
    pt, ref_pt = PhaseTimer("ec.encode"), ref_phases.PhaseTimer("ec.encode")
    encoder.write_ec_files(bases["port"], phases=pt, device="cpu", **blocks)
    ref_encoder.write_ec_files(bases["ref"], phases=ref_pt, **blocks)
    lanes = devices.LEDGER.snapshot(base)["lanes"]
    ref_lanes = ref_devices.LEDGER.snapshot(ref_base)["lanes"]

    def counts(rows):
        return [(r["lane"], r["chunks"], r["bytes"]) for r in rows]

    assert counts(lanes) == counts(ref_lanes)
    chunks = sum(-(-bs // 4096) for _, bs in
                 layout.encode_row_plan(size, LARGE, SMALL))
    assert counts(lanes) == [("0", chunks, 10 * sum(
        min(4096, bs - co) for _, bs in
        layout.encode_row_plan(size, LARGE, SMALL)
        for co in range(0, bs, 4096)))]
    # a cpu codec's dispatches are not device work
    assert devices.LEDGER.snapshot(base)["devices"] == []
    got, want = pt.finish(), ref_pt.finish()

    def shape(summary):
        return {name: (info["count"], info["bytes"])
                for name, info in summary["phases"].items()}

    assert shape(got) == shape(want)
    assert got["notes"] == want["notes"] == {"batch_bytes": 4096,
                                             "pipeline_depth": 3}
    assert got["op"] == want["op"]


def test_batch_encode_records_one_lane_a_volume(tmp_path):
    size, nvol = 54_321, 3
    bases = []
    for i in range(nvol):
        b = str(tmp_path / str(i + 1))
        with open(b + ".dat", "wb") as f:
            f.write(payload(size))
        bases.append(b)
    base = devices.LEDGER.baseline()
    encoder.write_ec_files_batch(bases, large_block_size=LARGE,
                                 small_block_size=SMALL, batch_bytes=4096,
                                 device="cpu")
    chunks = sum(-(-bs // 4096) for _, bs in
                 layout.encode_row_plan(size, LARGE, SMALL))
    lanes = devices.LEDGER.snapshot(base)["lanes"]
    assert [(r["lane"], r["chunks"]) for r in lanes] == [
        (str(vi), chunks) for vi in range(nvol)]
    assert sum(r["chunks"] for r in lanes) == chunks * nvol
    # a codec given to the batch encode must be of its shape
    with pytest.raises(ValueError):
        encoder.write_ec_files_batch(bases, rs=RSCodec(6, 3, device="cpu"))
