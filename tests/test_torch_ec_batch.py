"""The port's multi-volume encode, ``write_ec_files_batch``, held against
the reference's per-volume ``write_ec_files`` on the same payloads, byte
for byte, on the cases of tests/test_zero_copy.py (lockstep groups,
mixed and odd sizes, a tiny ``batch_bytes``), and its ``choose_pipeline``
against the reference's cold-link choice.
"""

import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import link as ref_link  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    encoder as ref_encoder,
)
from seaweedfs_tpu_torch.ops import codec  # noqa: E402
from seaweedfs_tpu_torch.parallel import make_mesh  # noqa: E402
from seaweedfs_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    encoder,
    write_ec_files_batch,
)
from seaweedfs_tpu_torch.telemetry.phases import PhaseTimer  # noqa: E402

LARGE, SMALL, BATCH = 1 << 14, 1 << 12, 1 << 11


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_volumes(root, sizes):
    """Each size as <root>/port/<i>.dat and the same bytes as
    <root>/ref/<i>.dat; returns the two lists of bases."""
    bases = {"port": [], "ref": []}
    for side in bases:
        os.makedirs(os.path.join(root, side))
    for i, size in enumerate(sizes):
        rng = np.random.default_rng(zlib.crc32(repr((i, size)).encode()))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for side, lst in bases.items():
            base = os.path.join(root, side, str(i + 1))
            with open(base + ".dat", "wb") as f:
                f.write(payload)
            lst.append(base)
    return bases["port"], bases["ref"]


@pytest.mark.parametrize("sizes", [
    pytest.param([90_000, 90_000, 90_000], id="lane-packed-3vol-lockstep"),
    pytest.param([90_000, 50_000, 90_000, 1_000], id="mixed-size-groups"),
    pytest.param([123_457], id="one-volume"),
    pytest.param([1, 999, 999, 100_001], id="odd-sizes"),
])
def test_batch_matches_reference_per_volume(tmp_path, sizes):
    port, ref = write_volumes(str(tmp_path), sizes)
    pt = PhaseTimer("ec.encode.batch")
    out = write_ec_files_batch(port, large_block_size=LARGE,
                               small_block_size=SMALL, batch_bytes=BATCH,
                               phases=pt, device="cpu")
    assert set(out) == set(port)
    for p_base, r_base in zip(port, ref):
        r_paths = ref_encoder.write_ec_files(
            r_base, large_block_size=LARGE, small_block_size=SMALL,
            batch_bytes=BATCH)
        assert out[p_base] == [p_base + C.to_ext(i) for i in range(14)]
        for p, r in zip(out[p_base], r_paths):
            assert read(p) == read(r), f"{p} differs"
    summary = pt.summary()
    assert summary["phases"]["read"]["bytes"] == sum(sizes)
    assert "flush" in summary["phases"]
    if max(sizes.count(s) for s in sizes) > 1:
        assert summary["notes"]["readers"] > 1


def test_batch_equals_write_ec_files_with_default_geometry(tmp_path):
    port, _ = write_volumes(str(tmp_path), [300_000, 300_000])
    out = write_ec_files_batch(port, device="cpu")
    for base in port:
        single = base + "_single"
        os.link(base + ".dat", single + ".dat")
        paths = encoder.write_ec_files(single, device="cpu")
        for a, b in zip(out[base], paths):
            assert read(a) == read(b)


def test_one_codec_launch_per_lane_packed_chunk(tmp_path, monkeypatch):
    """Each chunk of a lockstep group is one codec call on a [k, V·n]
    slab; volumes of another size form their own group."""
    calls = []
    real = codec.RSCodec.encode_async

    def spy(self, data):
        calls.append(tuple(data.shape))
        return real(self, data)

    monkeypatch.setattr(codec.RSCodec, "encode_async", spy)
    port, _ = write_volumes(str(tmp_path), [40_000, 40_000, 40_000, 7_000])
    write_ec_files_batch(port, large_block_size=LARGE,
                         small_block_size=SMALL, batch_bytes=BATCH,
                         device="cpu")

    def n_chunks(size):
        rows = encoder.encode_row_plan(size, LARGE, SMALL, C.DATA_SHARDS)
        return sum(-(-bs // BATCH) for _, bs in rows)

    assert len(calls) == n_chunks(40_000) + n_chunks(7_000)
    widths = {w for _, w in calls}
    assert 3 * BATCH in widths and all(k == C.DATA_SHARDS for k, _ in calls)


@pytest.mark.parametrize("dat_size", [1, 5000, 10 << 20, 1 << 30, 30 << 30])
@pytest.mark.parametrize("volumes", [1, 3, 8, 64])
def test_choose_pipeline_is_the_references_cold_link(monkeypatch, dat_size,
                                                     volumes):
    monkeypatch.setattr(ref_link, "estimates",
                        lambda: {"device": None, "host": None, "rtt_s": None})
    want = ref_encoder.choose_pipeline(dat_size, C.DATA_SHARDS, None,
                                       volumes=volumes, devices=1)
    assert encoder.choose_pipeline(dat_size, C.DATA_SHARDS, None,
                                   volumes=volumes) == want
    assert encoder.choose_pipeline(dat_size, volumes=volumes,
                                   batch_bytes=4096) == (4096, 3)


def test_mesh_and_no_card_raise(tmp_path, monkeypatch):
    port, _ = write_volumes(str(tmp_path), [100])
    # the mesh branch takes no codec, and only a device among its positions
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="no rs"):
        write_ec_files_batch(port, mesh=mesh,
                             rs=codec.RSCodec(device="cpu"))
    cards = Mesh(np.array([torch.device("cuda", 0)] * 2,
                          dtype=object).reshape(1, 2), ("vol", "seq"))
    with pytest.raises(ValueError, match="not a position"):
        write_ec_files_batch(port, mesh=cards, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        write_ec_files_batch(port)
    assert not os.path.exists(port[0] + C.to_ext(0))
    with pytest.raises(ValueError):
        encoder.choose_pipeline(1000, volumes=0)
