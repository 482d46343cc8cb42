"""The port's multi-GPU compute plane (``seaweedfs_tpu_torch.parallel``)
held against the reference's on the CPU: the same seeded numpy inputs go
through the reference on its 8 forced host devices and through the port
on a mesh of ``cpu`` positions, and every case must give identical bytes
(tolerance: 0 differing bytes). The cases are those of
tests/test_parallel.py, plus the checksum's uint32 wrap, the dispatch
cache's keys, the staging views and lane plan, and the raises.
"""

import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

import jax  # noqa: E402

from seaweedfs_tpu.ops import link as ref_link  # noqa: E402
from seaweedfs_tpu.parallel import ec_sharded as ref_sharded  # noqa: E402
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    write_ec_files_batch as ref_write_ec_files_batch,
)
from seaweedfs_tpu_torch.ops import codec  # noqa: E402
from seaweedfs_tpu_torch.ops import link as port_link  # noqa: E402
from seaweedfs_tpu_torch.parallel import (  # noqa: E402
    ec_sharded,
    encode_batch_parity,
    encode_sharded,
    encode_stripe_psum,
    make_mesh,
    sharded_ec_step,
)
from seaweedfs_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import (  # noqa: E402
    constants as C,
    write_ec_files_batch,
)


def cpu_mesh(n=8, axis_names=("vol", "seq")):
    return make_mesh(n, axis_names, devices=["cpu"] * n)


def seeded(case, shape):
    """Random bytes of ``shape`` from a seed derived from the case."""
    rng = np.random.default_rng(zlib.crc32(repr((case, shape)).encode()))
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.fixture(autouse=True)
def _eight_host_devices():
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs its 8-device host mesh")


@pytest.mark.parametrize("n,axes", [
    (8, ("vol", "seq")), (8, ("stripe",)), (4, ("vol", "seq")),
    (6, ("vol", "seq")), (2, ("vol", "seq")), (1, ("vol", "seq")),
    (8, ("a", "b", "c")),
])
def test_make_mesh_shapes(n, axes):
    mesh = cpu_mesh(n, axes)
    assert mesh.shape == dict(ref_make_mesh(n, axes).shape)
    assert mesh.size == n and mesh.axis_names == axes
    assert mesh.devices.reshape(1, -1).shape == (1, n)


def test_make_mesh_raises_as_the_reference():
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(8, shape=(3, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(devices=["meta"])


@pytest.mark.parametrize("v,n", [(8, 512), (4, 4096), (8, 1000)])
def test_encode_sharded_matches_reference(v, n):
    data = seeded("sharded", (v, 10, n))
    got = np.asarray(encode_sharded(data, cpu_mesh(), 10, 4))
    want = np.asarray(ref_sharded.encode_sharded(data, ref_make_mesh(8),
                                                 10, 4))
    assert got.shape == (v, 14, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,m,n_dev", [
    (10, 4, 8),  # the reference's full-mesh case
    (10, 4, 6),  # 80 bits % 6 != 0: ragged
    (10, 4, 3),  # 80 % 3 != 0
    (12, 4, 8),  # RS(12,4) on the full mesh
    (6, 3, 7),   # 48 % 7 != 0
])
def test_encode_stripe_psum_matches_reference(k, m, n_dev):
    data = seeded("stripe", (k, 192))
    got = np.asarray(encode_stripe_psum(
        data, cpu_mesh(n_dev, ("stripe",)), k, m))
    want = np.asarray(ref_sharded.encode_stripe_psum(
        data, ref_make_mesh(n_dev, ("stripe",)), k, m))
    assert got.shape == (m, 192)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v,n", [(4, 256), (8, 1000)])
def test_sharded_ec_step_matches_reference(v, n):
    data = seeded("step", (v, 10, n))
    shards, checksum = sharded_ec_step(data, cpu_mesh(), 10, 4)
    ref_shards, ref_checksum = ref_sharded.sharded_ec_step(
        data, ref_make_mesh(8), 10, 4)
    shards, checksum = np.asarray(shards), np.asarray(checksum)
    np.testing.assert_array_equal(shards, np.asarray(ref_shards))
    assert checksum.dtype == np.uint32 and checksum.shape == (v, 14)
    np.testing.assert_array_equal(checksum, np.asarray(ref_checksum))
    np.testing.assert_array_equal(checksum, shards.sum(axis=-1,
                                                       dtype=np.uint32))


@pytest.mark.parametrize("entry", ["encode_sharded", "sharded_ec_step"])
def test_uneven_split_raises_as_the_reference(entry):
    """Without padding, a dimension the mesh does not divide raises in
    both packages (the reference's ``NamedSharding`` requires it)."""
    data = seeded("uneven", (8, 10, 777))
    with pytest.raises(ValueError):
        getattr(ref_sharded, entry)(data, ref_make_mesh(8))
    with pytest.raises(ValueError):
        getattr(ec_sharded, entry)(data, cpu_mesh())


@pytest.mark.parametrize("parts", [2, 3, 8])
def test_checksum_combine_wraps_as_uint32(parts):
    """Partial sums whose total passes 2^32 give numpy's uint32 sum: the
    row sums of a full-size slab do, and the combine must wrap as the
    reference's ``jnp.sum(..., dtype=uint32)``."""
    rng = np.random.default_rng(parts)
    rows = rng.integers(0, 256, size=(3, 14, parts * 64), dtype=np.uint8)
    # each column weighs 2^26 bytes of 0..255, so the totals pass 2^32
    weight = np.int64(1 << 26)
    split = np.array_split(rows.astype(np.int64) * weight, parts, axis=-1)
    got = ec_sharded.combine_checksum(
        [torch.from_numpy(p.sum(axis=-1)) for p in split]).numpy()
    full = rows.astype(np.uint64).sum(axis=-1) * np.uint64(weight)
    assert (full >= 1 << 32).any()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  full.astype(np.uint32))
    assert got.max() <= 0xFFFFFFFF and got.min() >= 0


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("v,n", [(1, 777), (3, 1000), (5, 4096)])
def test_encode_batch_parity_matches_reference(v, n, defer):
    data = seeded("batch", (v, 10, n))
    got = encode_batch_parity(data, cpu_mesh(), 10, 4, defer=defer)
    want = ref_sharded.encode_batch_parity(data, ref_make_mesh(8), 10, 4,
                                           defer=defer)
    if defer:
        got, want = got(), want()
    assert isinstance(got, np.ndarray) and got.shape == (v, 4, n)
    np.testing.assert_array_equal(got, want)


def test_dispatch_cache_second_call_builds_nothing():
    """A repeat dispatch builds nothing and hits; a value-equal mesh made
    again hits the same entry; RS(8,4) on it is a new entry."""
    data = seeded("cache", (8, 10, 256))
    ec_sharded.reset_dispatch_cache()
    first = np.asarray(encode_sharded(data, cpu_mesh(), 10, 4))
    builds = ec_sharded.trace_counts()
    stats = ec_sharded.cache_stats()
    assert stats["misses"] == 1 and builds["encode_all"] == 1
    second = np.asarray(encode_sharded(data, cpu_mesh(), 10, 4))
    np.testing.assert_array_equal(first, second)
    assert ec_sharded.trace_counts() == builds
    assert ec_sharded.cache_stats()["hits"] > stats["hits"]
    encode_sharded(data[:, :8], cpu_mesh(), 8, 4)
    assert ec_sharded.cache_stats()["misses"] == 2
    assert ec_sharded.trace_counts()["encode_all"] == 2


def test_mesh_keys_by_value():
    a, b = cpu_mesh(), cpu_mesh()
    assert a == b and hash(a) == hash(b)
    assert cpu_mesh(8, ("stripe",)) != a
    assert cpu_mesh(4) != cpu_mesh(4, ("seq", "vol"))
    cards = Mesh(np.array([torch.device("cuda", 0)] * 8,
                          dtype=object).reshape(4, 2), ("vol", "seq"))
    assert cards != a and cards.shape == a.shape


def test_legacy_dispatch_byte_identical(monkeypatch):
    data = seeded("legacy", (8, 10, 512))
    monkeypatch.delenv("SEAWEEDFS_SHARDED_LEGACY", raising=False)
    staged = np.asarray(encode_sharded(data, cpu_mesh()))
    builds = ec_sharded.trace_counts()
    monkeypatch.setenv("SEAWEEDFS_SHARDED_LEGACY", "1")
    assert ec_sharded.legacy_dispatch_enabled()
    legacy = np.asarray(encode_sharded(data, cpu_mesh()))
    np.testing.assert_array_equal(staged, legacy)
    np.testing.assert_array_equal(
        legacy, np.asarray(ref_sharded.encode_sharded(data,
                                                      ref_make_mesh(8))))
    # the legacy path builds its entry per call, outside the cache
    assert ec_sharded.trace_counts() == builds


@pytest.mark.parametrize("shape,pad_to", [
    ((8, 10, 512), None), ((3, 10, 1000), (4, 10, 1000)),
    ((1, 10, 777), (1, 10, 784)), ((5, 10, 33), (8, 10, 34)),
])
def test_shard_views_are_the_references(shape, pad_to):
    """Each position's staged tile equals the reference's shard view of
    the logical (padded) shape, spill shards zero-filled."""
    data = seeded("views", shape)
    logical = pad_to or shape
    mesh = cpu_mesh()
    if logical[0] % mesh.shape["vol"]:
        mesh = Mesh(mesh.devices.reshape(1, -1), ("vol", "seq"))
    staged = ec_sharded.stage_lanes(data, mesh, pad_to=pad_to)
    assert staged.shape == tuple(logical)
    for sh in staged.addressable_shards:
        want = ref_sharded._shard_view(data, sh.index, logical)
        np.testing.assert_array_equal(sh.data.numpy(), want)


@pytest.mark.parametrize("n_lanes,lane_bytes", [
    (1, 0), (8, 10 << 20), (4, 1 << 16), (64, 3 << 20),
])
def test_choose_lane_plan_is_the_references_cold_link(monkeypatch, n_lanes,
                                                     lane_bytes):
    # both links cold: a test run earlier in this process may have probed
    # either package's process-wide link state
    monkeypatch.setattr(ref_link, "STATE", ref_link.LinkState())
    monkeypatch.setattr(port_link, "STATE", port_link.LinkState())
    assert ec_sharded.choose_lane_plan(n_lanes, lane_bytes) == \
        ref_sharded.choose_lane_plan(n_lanes, lane_bytes)


def test_write_ec_files_batch_mesh_matches_reference(tmp_path):
    """The mesh branch on a ``cpu`` mesh against the reference's
    ``write_ec_files_batch``, which takes its own mesh branch on the 8
    host devices: every shard file byte-identical, ragged sizes in two
    lockstep groups."""
    sizes = [700_001, 700_001, 700_001, 123_457]
    bases = {"port": [], "ref": []}
    for side, lst in bases.items():
        os.makedirs(tmp_path / side)
        for i, size in enumerate(sizes):
            base = str(tmp_path / side / str(i + 1))
            with open(base + ".dat", "wb") as f:
                f.write(seeded("files", (i, size)).tobytes())
            lst.append(base)
    blocks = dict(large_block_size=1 << 19, small_block_size=1 << 16,
                  batch_bytes=1 << 17)
    out = write_ec_files_batch(bases["port"], mesh=cpu_mesh(), **blocks)
    ref = ref_write_ec_files_batch(bases["ref"], **blocks)
    assert set(out) == set(bases["port"])
    for p_base, r_base in zip(bases["port"], bases["ref"]):
        assert out[p_base] == [p_base + C.to_ext(i) for i in range(14)]
        for p, r in zip(out[p_base], ref[r_base]):
            with open(p, "rb") as fp, open(r, "rb") as fr:
                assert fp.read() == fr.read(), p


def test_mesh_arguments_that_conflict_raise(tmp_path):
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(seeded("conflict", (1000,)).tobytes())
    with pytest.raises(ValueError, match="no rs"):
        write_ec_files_batch([base], mesh=cpu_mesh(2),
                             rs=codec.RSCodec(10, 4, device="cpu"))
    cards = Mesh(np.array([torch.device("cuda", 0)] * 2,
                          dtype=object).reshape(1, 2), ("vol", "seq"))
    with pytest.raises(ValueError, match="not a position"):
        write_ec_files_batch([base], mesh=cards, device="cpu")
    assert not os.path.exists(base + C.to_ext(0))


def test_no_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(b"\x01" * 100)
    with pytest.raises(RuntimeError):
        write_ec_files_batch([base], mesh=make_mesh())
    with pytest.raises(RuntimeError):
        make_mesh(devices=["cuda:0"] * 4)
    assert not os.path.exists(base + C.to_ext(0))
