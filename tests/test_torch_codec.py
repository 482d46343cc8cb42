"""The port's RSCodec against the reference's, byte for byte.

``RSCodec(device="cpu")`` runs the kernel's plain PyTorch version; the
reference codec runs whichever backend it routes to on this machine.
Without a card, a codec that was not told ``device="cpu"`` must raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops.codec import RSCodec as RefCodec  # noqa: E402
import seaweedfs_tpu_torch  # noqa: E402
from seaweedfs_tpu_torch.ops import codec as codec_mod  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256  # noqa: E402
from seaweedfs_tpu_torch.ops.codec import RSCodec  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import gf_swar  # noqa: E402

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("k,m,n", [(10, 4, 1), (10, 4, 1000), (6, 3, 4097),
                                   (12, 4, 300)])
def test_encode_matches_reference(k, m, n):
    data = RNG.integers(0, 256, (k, n), dtype=np.uint8)
    port, ref = RSCodec(k, m, device="cpu"), RefCodec(k, m)
    want = np.asarray(ref.encode(data))
    np.testing.assert_array_equal(port.encode(data), want)
    pending = port.encode_async(data)
    assert pending.backend == "cpu"
    np.testing.assert_array_equal(pending.result(), want)
    assert pending.result() is pending.result()  # memoised
    np.testing.assert_array_equal(
        port.encode_shards(data), ref.encode_shards(data)
    )


def test_batched_and_strided_encode():
    port, ref = RSCodec(10, 4, device="cpu"), RefCodec(10, 4)
    data = RNG.integers(0, 256, (3, 10, 500), dtype=np.uint8)
    np.testing.assert_array_equal(
        port.encode(data), np.asarray(ref.encode(data))
    )
    slab = RNG.integers(0, 256, (10, 4096), dtype=np.uint8)
    view = slab[:, :1808]  # a strided slab view, as the encoder passes
    np.testing.assert_array_equal(
        port.encode_async(view).result(), np.asarray(ref.encode(view))
    )


def test_verify():
    port = RSCodec(10, 4, device="cpu")
    data = RNG.integers(0, 256, (10, 777), dtype=np.uint8)
    shards = port.encode_shards(data)
    assert port.verify(shards)
    assert RefCodec(10, 4).verify(shards)
    shards[12, 5] ^= 1
    assert not port.verify(shards)


@pytest.mark.parametrize(
    "lost", [(0,), (13,), (2, 9), (0, 3, 11, 13), (10, 11, 12, 13)]
)
def test_reconstruct_matches_reference(lost):
    k, m, n = 10, 4, 2048
    port, ref = RSCodec(k, m, device="cpu"), RefCodec(k, m)
    data = RNG.integers(0, 256, (k, n), dtype=np.uint8)
    shards = np.concatenate([data, np.asarray(ref.encode(data))])
    present = {i: shards[i] for i in range(k + m) if i not in lost}
    got = port.reconstruct(present)
    want = ref.reconstruct(present)
    assert sorted(got) == sorted(want) == list(lost)
    for sid in lost:
        np.testing.assert_array_equal(got[sid], want[sid])
        np.testing.assert_array_equal(got[sid], shards[sid])
    # wanted= restricts the rows computed, as in the reference
    one = port.reconstruct(present, wanted=[lost[-1]])
    assert list(one) == [lost[-1]]
    np.testing.assert_array_equal(one[lost[-1]], shards[lost[-1]])
    got_d = port.reconstruct_data(present)
    want_d = ref.reconstruct_data(present)
    assert sorted(got_d) == sorted(want_d)
    for sid in want_d:
        np.testing.assert_array_equal(got_d[sid], want_d[sid])


def test_reconstruct_edge_cases():
    port = RSCodec(10, 4, device="cpu")
    data = RNG.integers(0, 256, (10, 64), dtype=np.uint8)
    shards = port.encode_shards(data)
    assert port.reconstruct({i: shards[i] for i in range(14)}) == {}
    with pytest.raises(ValueError):
        port.reconstruct({i: shards[i] for i in range(9)})


def test_window_rows_reach_the_codec_without_a_copy():
    """Rows that are consecutive rows of one buffer (a rebuild window)
    are dispatched as that buffer; any other rows are stacked."""
    window = RNG.integers(0, 256, (12, 96), dtype=np.uint8)
    rows = [window[i] for i in range(10)]
    view = codec_mod._stacked(rows)
    assert np.shares_memory(view, window) and view.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(view, window[:10])
    for other in ([window[i] for i in (0, 2, 3)],
                  [window[1], window[0]],
                  [window[i].copy() for i in range(3)]):
        got = codec_mod._stacked(other)
        assert not np.shares_memory(got, window)
        np.testing.assert_array_equal(got, np.stack(other))
    port, ref = RSCodec(10, 4, device="cpu"), RefCodec(10, 4)
    present = {i: window[i] for i in range(10)}
    present.update({10: window[10]})
    got = port.reconstruct(present, wanted=[11, 12, 13])
    want = ref.reconstruct(present, wanted=[11, 12, 13])
    for sid in (11, 12, 13):
        np.testing.assert_array_equal(got[sid], want[sid])


def test_codec_argument_checks():
    with pytest.raises(ValueError):
        RSCodec(0, 4, device="cpu")
    with pytest.raises(ValueError):
        RSCodec(10, 17, device="cpu")  # past the kernel's 16 outputs
    with pytest.raises(ValueError):
        RSCodec(10, 4, device="cpu").encode(np.zeros((9, 8), np.uint8))
    with pytest.raises(ValueError):
        RSCodec(10, 4, device="meta")


def test_cpu_codec_never_launches_the_kernel():
    before = gf_swar.LAUNCHES.value
    RSCodec(10, 4, device="cpu").encode(np.ones((10, 4096), np.uint8))
    assert gf_swar.LAUNCHES.value == before


def test_no_card_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        seaweedfs_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        RSCodec()
    with pytest.raises(RuntimeError):
        RSCodec(10, 4, device="cuda")


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_cuda_codec_matches_reference():
    # floor 0: every dispatch, needle-sized ones too, takes the kernel
    port, ref = RSCodec(10, 4, device_min_bytes=0), RefCodec(10, 4)
    assert port.backend == "cuda"
    for n in (1, 1000, 1 << 20):
        data = RNG.integers(0, 256, (10, n), dtype=np.uint8)
        before = gf_swar.LAUNCHES.value
        np.testing.assert_array_equal(
            port.encode(data), np.asarray(ref.encode(data))
        )
        assert gf_swar.LAUNCHES.value == before + 1
    shards = port.encode_shards(data)
    present = {i: shards[i] for i in range(14) if i not in (0, 5, 11, 13)}
    got = port.reconstruct(present)
    for sid in (0, 5, 11, 13):
        np.testing.assert_array_equal(got[sid], shards[sid])


WIDTHS = {  # name -> width, given the floor
    "0": lambda floor: 0, "1": lambda floor: 1, "4095": lambda floor: 4095,
    "64KiB": lambda floor: 1 << 16, "floor-1": lambda floor: floor - 1,
    "floor": lambda floor: floor, "floor+1": lambda floor: floor + 1,
    "4MiB": lambda floor: 1 << 22,
}


@pytest.mark.parametrize("name", list(WIDTHS))
def test_routing_sends_narrow_dispatches_to_the_host(name):
    floor = codec_mod.DEVICE_MIN_BYTES
    width = WIDTHS[name](floor)
    want = "native" if width < floor else "cuda"
    assert codec_mod.choose_route("cuda", width, floor) == want
    # a floor of 0 sends everything to the kernel
    assert codec_mod.choose_route("cuda", width, 0) == "cuda"
    # the cpu codec stays the plain version at every size
    assert codec_mod.choose_route("cpu", width, floor) == "cpu"
    assert codec_mod.choose_route("cpu", width, 0) == "cpu"


def test_floor_keyword():
    assert RSCodec(device="cpu").device_min_bytes == (
        codec_mod.DEVICE_MIN_BYTES)
    assert RSCodec(device="cpu", device_min_bytes=0).device_min_bytes == 0
    with pytest.raises(ValueError):
        RSCodec(device="cpu", device_min_bytes=-1)


@pytest.fixture
def host_route(monkeypatch):
    """Every dispatch on the native host route, as a ``cuda`` codec's
    under its floor."""
    monkeypatch.setattr(codec_mod, "choose_route",
                        lambda backend, n, floor: "native")


def test_host_route_matches_reference(host_route):
    port, ref = RSCodec(10, 4, device="cpu"), RefCodec(10, 4)
    data = RNG.integers(0, 256, (10, 3001), dtype=np.uint8)
    before = codec_mod.HOST_DISPATCHES.value
    launches = gf_swar.LAUNCHES.value
    want = np.asarray(ref.encode(data))
    np.testing.assert_array_equal(port.encode(data), want)
    pending = port.encode_async(data)
    assert pending.backend == "native"
    np.testing.assert_array_equal(pending.result(), want)
    batch = RNG.integers(0, 256, (3, 10, 500), dtype=np.uint8)
    np.testing.assert_array_equal(port.encode_async(batch).result(),
                                  np.asarray(ref.encode(batch)))
    deep = batch.reshape(3, 1, 10, 500)  # more leading dims
    np.testing.assert_array_equal(port.encode_async(deep).result(),
                                  np.asarray(ref.encode(batch))[:, None])
    shards = np.concatenate([data, want])
    present = {i: shards[i] for i in range(14) if i not in (0, 5, 11, 13)}
    got = port.reconstruct(present)
    for sid in (0, 5, 11, 13):
        np.testing.assert_array_equal(got[sid], shards[sid])
    one = port.reconstruct(present, wanted=[5])
    np.testing.assert_array_equal(one[5], ref.reconstruct(
        present, wanted=[5])[5])
    assert codec_mod.HOST_DISPATCHES.value - before == 6
    assert gf_swar.LAUNCHES.value == launches


def test_host_route_overlaps_on_the_pool(host_route):
    """encode_async returns before the host work is read, and each
    handle's result is its own."""
    port = RSCodec(10, 4, device="cpu")
    slabs = [RNG.integers(0, 256, (10, 20_000), dtype=np.uint8)
             for _ in range(6)]
    handles = [port.encode_async(s) for s in slabs]
    for s, h in zip(slabs, handles):
        np.testing.assert_array_equal(
            h.result(), gf256.gf_matmul_cpu(gf256.parity_matrix(10, 4), s))
