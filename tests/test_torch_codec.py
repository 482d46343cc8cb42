"""The port's RSCodec against the reference's, byte for byte.

``RSCodec(device="cpu")`` runs the kernel's plain PyTorch version; the
reference codec runs whichever backend it routes to on this machine.
Without a card, a codec that was not told ``device="cpu"`` must raise.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops.codec import RSCodec as RefCodec  # noqa: E402
import seaweedfs_tpu_torch  # noqa: E402
from seaweedfs_tpu_torch import fault, tracing  # noqa: E402
from seaweedfs_tpu_torch.ops import link, profiler  # noqa: E402
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
    # floor 0 and no link routing: every dispatch, needle-sized ones
    # too, takes the kernel
    port, ref = (RSCodec(10, 4, device_min_bytes=0, link_aware=False),
                 RefCodec(10, 4))
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


# -- routing reasons and recording (the reference's _choose_backend and
# _record order) ---------------------------------------------------------

PROBE = {"h2d_gbps": 24.0, "d2h_gbps": 21.5, "rtt_s": 4e-5,
         "probe_bytes": float(1 << 20)}


@pytest.fixture
def link_state(monkeypatch):
    """A fresh, probed link state with the card far ahead of the host."""
    st = link.LinkState()
    st.probe_result = dict(PROBE)
    st._gbps = {"device": 40.0, "host": 2.0}
    monkeypatch.setattr(link, "STATE", st)
    return st


def routes_delta(before):
    now = link.ROUTE_TOTAL.values()
    return {key: v - before.get(key, 0.0) for key, v in now.items()
            if v != before.get(key, 0.0)}


def test_choose_backend_reasons(link_state):
    floor = codec_mod.DEVICE_MIN_BYTES
    mib = 1 << 20
    cb = codec_mod.choose_backend
    assert cb("cuda", floor - 1, 10 * floor, floor) == ("native", "size")
    assert cb("cuda", mib, 10 * mib, floor) == ("cuda", "link")
    assert cb("cuda", mib, 10 * mib, floor, link_aware=False) == (
        "cuda", "static")
    assert cb("cpu", mib, 10 * mib, floor) == ("cpu", "platform")
    assert cb("cpu", 1, 10, floor, link_aware=False) == ("cpu", "platform")
    # the link degrades: the host wins, and every 32nd dispatch re-probes
    link_state._gbps = {"device": 0.001, "host": 2.0}
    got = [cb("cuda", mib, 10 * mib, floor) for _ in range(64)]
    assert got.count(("cuda", "probe")) == 2
    assert got.count(("native", "link")) == 62
    # never observed: the card by default
    link_state._gbps = {}
    assert cb("cuda", mib, 10 * mib, floor) == ("cuda", "default")
    # the floor stays first whatever the link says
    assert cb("cuda", 1024, 10 * mib, floor) == ("native", "size")


def test_link_aware_keyword():
    assert RSCodec(device="cpu").link_aware is True
    assert RSCodec(device="cpu", link_aware=False).link_aware is False


@pytest.fixture
def above_floor(monkeypatch, link_state):
    """A cpu codec routed as a ``cuda`` codec above its floor, with the
    host ahead, so link routing sends it to the native codec."""
    monkeypatch.setattr(codec_mod, "choose_route",
                        lambda backend, n, floor: "cuda")
    link_state._gbps = {"device": 0.001, "host": 2.0}
    return link_state


def test_link_routed_host_dispatch_records_and_feeds_the_ewma(above_floor):
    port, ref = RSCodec(10, 4, device="cpu"), RefCodec(10, 4)
    data = RNG.integers(0, 256, (10, 3000), dtype=np.uint8)
    before = link.ROUTE_TOTAL.values()
    host_dispatches = codec_mod.HOST_DISPATCHES.value
    with tracing.start_span("ec", "encode") as root:
        got = port.encode(data)
    np.testing.assert_array_equal(got, np.asarray(ref.encode(data)))
    assert routes_delta(before) == {("host", "link"): 1.0}
    assert codec_mod.HOST_DISPATCHES.value == host_dispatches + 1
    assert above_floor.estimate("host") != 2.0  # the EWMA moved
    spans = tracing.RECORDER.spans(trace_id=root.trace_id)
    assert [s.op for s in spans] == ["encode(native,4x10)", "encode"]
    assert spans[0].parent_id == root.span_id


def test_failing_dispatch_counts_an_error_and_feeds_nothing(above_floor,
                                                            monkeypatch):
    def broken(matrix, data):
        raise RuntimeError("native codec failed")

    monkeypatch.setattr(codec_mod, "_native_matmul", broken)
    port = RSCodec(10, 4, device="cpu")
    before = link.ROUTE_TOTAL.values()
    bytes_before = profiler.DISPATCH_BYTES.values()
    with pytest.raises(RuntimeError, match="native codec failed"):
        port.encode(np.zeros((10, 3000), np.uint8))
    assert routes_delta(before) == {("host", "error"): 1.0}
    assert above_floor._gbps == {"device": 0.001, "host": 2.0}
    assert profiler.DISPATCH_BYTES.values() == bytes_before


def test_floor_dispatch_is_not_routable(host_route, link_state):
    """Under the floor ("size") a dispatch is recorded but feeds no
    estimate; so is the plain version ("platform")."""
    port = RSCodec(10, 4, device="cpu")
    before = link.ROUTE_TOTAL.values()
    gbps = dict(link_state._gbps)
    bytes_before = profiler.DISPATCH_BYTES.values().get(
        ("native", "4x10"), 0.0)
    port.encode(np.ones((10, 1000), np.uint8))
    assert routes_delta(before) == {("host", "size"): 1.0}
    assert profiler.DISPATCH_BYTES.values()[("native", "4x10")] - \
        bytes_before == 10_000
    assert link_state._gbps == gbps


def test_cpu_codec_records_platform_and_feeds_nothing(link_state):
    port = RSCodec(10, 4, device="cpu")
    before = link.ROUTE_TOTAL.values()
    gbps = dict(link_state._gbps)
    port.encode(np.ones((10, 1000), np.uint8))
    assert port.encode_async(np.ones((10, 64), np.uint8)).result().shape \
        == (4, 64)
    assert routes_delta(before) == {("host", "platform"): 2.0}
    assert link_state._gbps == gbps


def test_async_native_dispatch_records_in_the_worker(above_floor,
                                                     monkeypatch):
    calls = []
    real = codec_mod._record

    def spy(*args, **kw):
        calls.append(threading.current_thread())
        real(*args, **kw)

    monkeypatch.setattr(codec_mod, "_record", spy)
    port = RSCodec(10, 4, device="cpu")
    data = RNG.integers(0, 256, (10, 5000), dtype=np.uint8)
    with tracing.start_span("ec", "encode") as root:
        pending = port.encode_async(data)
    np.testing.assert_array_equal(
        pending.result(),
        gf256.gf_matmul_cpu(gf256.parity_matrix(10, 4), data))
    assert pending.backend == "native"
    assert len(calls) == 1 and calls[0] is not threading.current_thread()
    # the worker's record hangs under the span that launched it
    spans = tracing.RECORDER.spans(trace_id=root.trace_id)
    assert sorted(s.op for s in spans) == ["encode", "encode(native,4x10)"]
    assert all(s.parent_id == root.span_id for s in spans
               if s.component == "codec")
    pending.result()
    assert len(calls) == 1  # memoised: recorded once


def test_fault_point_runs_before_any_work(monkeypatch):
    monkeypatch.setattr(fault, "REGISTRY", fault.FaultRegistry())
    fault.REGISTRY.inject("codec.dispatch", count=1, peer="cpu")
    port = RSCodec(10, 4, device="cpu")
    before = link.ROUTE_TOTAL.values()
    with pytest.raises(fault.FaultInjected):
        port.encode(np.ones((10, 64), np.uint8))
    assert routes_delta(before) == {}  # no work ran, nothing recorded
    port.encode(np.ones((10, 64), np.uint8))  # count=1: fired once


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_cuda_codec_probe_failure_raises(monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(link, "STATE", link.LinkState())
    monkeypatch.setattr(link, "_measure_link", broken)
    port = RSCodec(10, 4)
    before = link.ROUTE_TOTAL.values()
    with pytest.raises(RuntimeError, match="probe failed"):
        port.encode(np.ones((10, 1 << 20), np.uint8))
    assert ("host", "noprobe") not in routes_delta(before)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_cuda_codec_routes_through_the_link(link_state):
    port = RSCodec(10, 4)
    data = RNG.integers(0, 256, (10, 1 << 20), dtype=np.uint8)
    before = link.ROUTE_TOTAL.values()
    launches = gf_swar.LAUNCHES.value
    np.testing.assert_array_equal(
        port.encode(data), np.asarray(RefCodec(10, 4).encode(data)))
    assert routes_delta(before) == {("device", "link"): 1.0}
    assert gf_swar.LAUNCHES.value == launches + 1
