"""The port's fault injection against the reference's: the same specs
and seeds fire on the same traversals, the same ``SEAWEEDFS_FAULTS``
JSON arms the same specs, and the codec's ``codec.dispatch`` point fails
an EC encode on the port's codec."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu import fault as ref_fault  # noqa: E402
from seaweedfs_tpu_torch import fault  # noqa: E402
from seaweedfs_tpu_torch import tracing  # noqa: E402
from seaweedfs_tpu_torch.ops.codec import RSCodec  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import encoder  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "1")

SPECS = {  # name -> the specs armed, in order
    "probability": [dict(point="p", probability=0.3, seed=7)],
    "count": [dict(point="p", count=5)],
    "probability and count": [dict(point="p", probability=0.5, count=40,
                                   seed=11)],
    "peer": [dict(point="p", kind="partition", peer="vol-2", seed=3,
                  probability=0.75)],
    "latency": [dict(point="p", kind="latency", delay=0.0,
                     probability=0.2, seed=5)],
    "stacked": [dict(point="p", kind="conn_drop", count=3),
                dict(point="p", probability=0.1, seed=99, status=500),
                dict(point="q", count=1)],
}


def traversals(n=1000):
    peers = ("vol-1:8080", "vol-2:8080", "filer")
    for i in range(n):
        yield ("p" if i % 7 else "q"), {"peer": peers[i % 3], "op": i}


def fire_sequence(pkg, specs, monkeypatch):
    """Kinds (or None) over 1,000 traversals of ``pkg.point`` on a fresh
    registry of ``pkg``, and the specs' state after them."""
    reg = pkg.FaultRegistry()
    monkeypatch.setattr(pkg, "REGISTRY", reg)
    for d in specs:
        reg.inject(**d)
    out = []
    for name, ctx in traversals():
        try:
            pkg.point(name, **ctx)
            out.append(None)
        except pkg.FaultInjected as e:
            out.append((e.point, e.kind, e.status))
    return out, reg.list()


@pytest.mark.parametrize("name", list(SPECS))
def test_fire_sequences_match_reference(name, monkeypatch):
    got, port_state = fire_sequence(fault, SPECS[name], monkeypatch)
    want, ref_state = fire_sequence(ref_fault, SPECS[name], monkeypatch)
    assert got == want
    assert port_state == ref_state
    if name != "latency":
        assert any(got) and not all(got)  # the specs fired, not always


def test_pick_sequences_match_reference():
    """The registry's own decision, traversal by traversal."""
    port, ref = fault.FaultRegistry(), ref_fault.FaultRegistry()
    for reg in (port, ref):
        reg.inject("p", probability=0.4, seed=1, count=100)
        reg.inject("p", kind="latency", peer="vol-1", seed=2)
    seq = []
    for name, ctx in traversals():
        a, b = port.pick(name, ctx), ref.pick(name, ctx)
        assert (a and a.to_dict()) == (b and b.to_dict())
        seq.append(a and a.kind)
    assert seq.count("error") == 100
    assert port.armed and ref.armed
    port.clear("p")
    ref.clear("p")
    assert port.list() == ref.list() == []
    assert not port.armed


def test_bad_specs_raise_as_in_reference():
    for pkg in (fault, ref_fault):
        with pytest.raises(ValueError):
            pkg.FaultRegistry().inject("p", kind="meteor")
        with pytest.raises(TypeError):
            pkg.FaultRegistry().inject("p", colour="red")


ENV_SPECS = [
    json.dumps([{"point": "codec.dispatch", "count": 2},
                {"point": "ec.shard.read", "kind": "latency",
                 "delay": 0.0, "probability": 0.5, "seed": 4}]),
    "[]",
]


@pytest.mark.parametrize("raw", ENV_SPECS)
def test_env_load_matches_reference(raw, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_FAULTS", raw)
    state = []
    for pkg in (fault, ref_fault):
        monkeypatch.setattr(pkg, "REGISTRY", pkg.FaultRegistry())
        pkg._configure_from_env()
        state.append(pkg.REGISTRY.list())
    assert state[0] == state[1]
    assert len(state[0]) == len(json.loads(raw))


def test_bad_env_raises_as_in_reference(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_FAULTS", "{not json")
    for pkg in (fault, ref_fault):
        monkeypatch.setattr(pkg, "REGISTRY", pkg.FaultRegistry())
        with pytest.raises(ValueError, match="SEAWEEDFS_FAULTS"):
            pkg._configure_from_env()


def test_fault_tags_the_active_span(monkeypatch):
    monkeypatch.setattr(fault, "REGISTRY", fault.FaultRegistry())
    fault.REGISTRY.inject("codec.dispatch", kind="latency", delay=0.0)
    with tracing.start_span("ec", "encode") as span:
        fault.point("codec.dispatch", backend="cpu", n_bytes=1)
    assert span.attrs == {"fault.point": "codec.dispatch",
                          "fault.kind": "latency"}


def test_codec_dispatch_fault_fails_write_ec_files(tmp_path, monkeypatch):
    """Armed once on a ``cpu`` codec, ``codec.dispatch`` fails the encode
    with ``FaultInjected`` and counts one injection; the next encode of
    the volume is the golden one."""
    monkeypatch.setattr(fault, "REGISTRY", fault.FaultRegistry())
    base = str(tmp_path / "1")
    shutil.copy(GOLDEN + ".dat", base + ".dat")
    blocks = dict(large_block_size=10_000, small_block_size=100,
                  batch_bytes=4096)
    rs = RSCodec(10, 4, device="cpu")
    before = fault.FAULT_INJECTED.values().get(
        ("codec.dispatch", "error"), 0.0)
    fault.REGISTRY.inject("codec.dispatch", count=1)
    with pytest.raises(fault.FaultInjected) as e:
        encoder.write_ec_files(base, rs=rs, **blocks)
    assert (e.value.point, e.value.kind) == ("codec.dispatch", "error")
    assert fault.FAULT_INJECTED.values()[("codec.dispatch", "error")] \
        - before == 1
    assert fault.REGISTRY.list()[0]["fired"] == 1
    encoder.write_ec_files(base, rs=rs, **blocks)
    for i in range(14):
        ext = f".ec{i:02d}"
        with open(base + ext, "rb") as a, open(GOLDEN + ext, "rb") as b:
            assert a.read() == b.read(), ext
    # every route runs the point: the plain version's too
    fault.REGISTRY.inject("codec.dispatch", kind="conn_drop", count=1)
    with pytest.raises(fault.FaultInjected):
        rs.encode(np.zeros((10, 64), np.uint8))
