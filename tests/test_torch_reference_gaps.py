"""The last names the port lacked, held against the reference on the CPU.

(a) A started master's flight-recorder frame: the same probe keys in
    both packages, ``master_agg_lock_wait_ms`` among them
    (``ClusterTelemetry.probe_lock_wait_seconds``).
(b) ``ops/gf256.reconstruct_cpu`` over every 1- to 4-loss pattern of
    RS(10,4), byte for byte, and its "too few shards" error.
(c) ``storage/idx.walk_index_file`` at both offset widths, as a
    generator and with a callback, from a path and from a file object.
(d) ``native.available()``: it reports whether the host codec loads and
    no path of the port routes by it.
(e) ``telemetry/devices.IMBALANCE_THRESHOLD``.
"""

import ast
import io
import itertools
import math
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.server import master as ref_master  # noqa: E402
from seaweedfs_tpu.storage import idx as ref_idx  # noqa: E402
from seaweedfs_tpu.storage import types as ref_types  # noqa: E402
from seaweedfs_tpu.telemetry import devices as ref_devices  # noqa: E402
from seaweedfs_tpu.telemetry import recorder as ref_flight  # noqa: E402
from seaweedfs_tpu_torch import native  # noqa: E402
from seaweedfs_tpu_torch.ops import codec  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256 as port_gf256  # noqa: E402
from seaweedfs_tpu_torch.server import master as port_master  # noqa: E402
from seaweedfs_tpu_torch.storage import idx as port_idx  # noqa: E402
from seaweedfs_tpu_torch.storage import types as port_types  # noqa: E402
from seaweedfs_tpu_torch.telemetry import devices as port_devices  # noqa: E402,E501
from seaweedfs_tpu_torch.telemetry import recorder as port_flight  # noqa: E402,E501

PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "seaweedfs_tpu_torch")


# -- (a) the master's recorder probes ----------------------------------------


def _probe_keys(monkeypatch, flight, master_mod):
    rec = flight.FlightRecorder(capacity=8)
    monkeypatch.setattr(flight, "RECORDER", rec)
    m = master_mod.MasterServer(pulse_seconds=0.2)
    m.start()
    try:
        frame = rec.sample()
    finally:
        m.stop()
    return frame


def test_master_probes_same_keys(monkeypatch):
    frames = {
        "ref": _probe_keys(monkeypatch, ref_flight, ref_master),
        "port": _probe_keys(monkeypatch, port_flight, port_master),
    }
    keys = {name: sorted(k for k in f if not k.startswith(("m.", "g.")))
            for name, f in frames.items()}
    assert keys["port"] == keys["ref"]
    wait = frames["port"]["master_agg_lock_wait_ms"]
    assert math.isfinite(wait) and wait >= 0.0


# -- (b) reconstruct_cpu ------------------------------------------------------


@pytest.mark.parametrize("losses", [1, 2, 3, 4])
def test_reconstruct_cpu_every_loss_pattern(losses):
    k, m = 10, 4
    rng = np.random.default_rng(22 + losses)
    data = rng.integers(0, 256, (k, 96), dtype=np.uint8)
    shards = dict(enumerate(np.concatenate(
        [data, ref_gf256.encode_cpu(data, m)])))
    for lost in itertools.combinations(range(k + m), losses):
        present = {i: s for i, s in shards.items() if i not in lost}
        got = port_gf256.reconstruct_cpu(present, k, m)
        want = ref_gf256.reconstruct_cpu(present, k, m)
        assert sorted(got) == sorted(want) == list(lost)
        for sid in lost:
            assert got[sid].tobytes() == want[sid].tobytes(), (lost, sid)
            assert got[sid].tobytes() == shards[sid].tobytes(), (lost, sid)
    assert port_gf256.reconstruct_cpu(shards, k, m) == \
        ref_gf256.reconstruct_cpu(shards, k, m) == {}


def test_reconstruct_cpu_too_few_shards():
    data = np.zeros((10, 8), dtype=np.uint8)
    shards = {i: data[i] for i in range(9)}
    errors = []
    for mod in (ref_gf256, port_gf256):
        with pytest.raises(ValueError) as e:
            mod.reconstruct_cpu(shards, 10, 4)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- (c) walk_index_file ------------------------------------------------------


@pytest.fixture(params=[4, 5])
def offset_size(request):
    before = (ref_types.OFFSET_SIZE, port_types.OFFSET_SIZE)
    ref_types.set_offset_size(request.param)
    port_types.set_offset_size(request.param)
    try:
        yield request.param
    finally:
        ref_types.set_offset_size(before[0])
        port_types.set_offset_size(before[1])


@pytest.mark.parametrize("source", ["path", "file"])
def test_walk_index_file(tmp_path, offset_size, source):
    rng = np.random.default_rng(offset_size)
    n = 300
    entries = np.zeros(n, dtype=port_idx.ENTRY_DTYPE)
    entries["key"] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    limit = 1 << (8 * offset_size)
    entries["offset"] = rng.integers(0, limit, n, dtype=np.int64) * 8
    entries["size"] = rng.integers(-1, 1 << 20, n, dtype=np.int32)
    blob = port_idx.pack_entries(entries)
    assert blob == ref_idx.pack_entries(entries)
    assert len(blob) == n * port_types.NEEDLE_MAP_ENTRY_SIZE
    path = tmp_path / "1.idx"
    path.write_bytes(blob + b"\x01\x02")  # a torn tail entry is skipped

    def src():
        return str(path) if source == "path" else io.BytesIO(
            path.read_bytes())

    walked = {}
    for name, mod in (("ref", ref_idx), ("port", port_idx)):
        gen = list(mod.walk_index_file(src()))
        calls = []
        assert mod.walk_index_file(
            src(), lambda *e, c=calls: c.append(e)) is None
        assert gen == calls
        walked[name] = gen
    assert walked["port"] == walked["ref"]
    assert walked["port"] == [
        (int(e["key"]), int(e["offset"]), int(e["size"])) for e in entries]


# -- (d) native.available -----------------------------------------------------


def _routes():
    return [codec.choose_backend(b, s, 10 * s, 1 << 16, link_aware=False)
            for b in ("cpu", "cuda") for s in (4096, 1 << 20)]


def test_native_available_reports(monkeypatch):
    native.library()
    assert native.available() is True
    routes = _routes()

    def refuse(*_a, **_k):
        raise native.NativeUnavailable("no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compile_library", refuse)
    assert native.available() is False
    assert _routes() == routes
    # a caller that needs the codec still raises: nothing stands in
    with pytest.raises(native.NativeUnavailable):
        native.gf_matmul(np.ones((1, 1), np.uint8), np.ones((1, 4), np.uint8))


def test_no_port_module_routes_by_native_available():
    """``available`` is read by no module of the port but its own."""
    own = os.path.join(PORT, "native", "__init__.py")
    for root, _, names in os.walk(PORT):
        for n in names:
            path = os.path.join(root, n)
            if not n.endswith(".py") or path == own:
                continue
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute):
                    assert not (node.attr == "available"
                                and isinstance(node.value, ast.Name)
                                and node.value.id == "native"), path
                elif isinstance(node, ast.ImportFrom):
                    assert not ((node.module or "").endswith("native")
                                and any(a.name == "available"
                                        for a in node.names)), path


# -- (e) IMBALANCE_THRESHOLD --------------------------------------------------


def test_imbalance_threshold():
    assert port_devices.IMBALANCE_THRESHOLD == \
        ref_devices.IMBALANCE_THRESHOLD == 0.20
