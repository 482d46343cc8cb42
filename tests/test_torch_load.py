"""The port's load generator (``command/benchmark.py``) held against the
reference's on the CPU.

The parsers and ``KeySet``'s zipfian draws are compared over many seeds
and specs. Then one short seeded ``run_benchmark`` of each package runs
against its own cluster (the reference's ``ClusterHarness`` and the
port's with ``device="cpu"``) on one worker, so the op sequence is a
function of the seed alone: both give the same ops, the same outcomes,
the same per-phase counts and the same result keys, and each pushes its
summary to its own master's ``/cluster/benchmark``. The S3 persona of
each package runs against its own gateway with the same ops, bytes and
counts; the mount and broker personas run through the port's ``WFS``
and broker (held to the reference's in ``test_torch_personas.py``).
"""

import random

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.command import benchmark as ref_bench  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefHarness,
)
from seaweedfs_tpu.telemetry import snapshot as ref_snap  # noqa: E402
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.command import benchmark as port_bench  # noqa: E402,E501
from seaweedfs_tpu_torch.server.harness import (  # noqa: E402
    ClusterHarness as PortHarness,
)
from seaweedfs_tpu_torch.telemetry import snapshot as port_snap  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

BENCH = {"ref": ref_bench, "port": port_bench}


@pytest.fixture(autouse=True)
def fresh_protocols(monkeypatch):
    """A fresh persona ledger for each package's snapshot and load
    generator (which binds ``PROTOCOLS`` by name) for the test's length:
    a persona run here records sections that a later test in the same
    process, of either package, must not find."""
    for snap, bench in ((ref_snap, ref_bench), (port_snap, port_bench)):
        ledger = snap.ProtocolAccounting()
        monkeypatch.setattr(snap, "PROTOCOLS", ledger)
        monkeypatch.setattr(bench, "PROTOCOLS", ledger)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


MIXES = ["write:30,read:60,delete:10", "read", "write:1,read:0",
         " write : 2 , delete:3,", "", "write:0", "scan:5", "read:x"]
SIZES = [("", 1024), ("1024", 7), ("512-4096", 1), ("9-3", 1),
         ("0", 5), ("x", 1)]
PERSONAS = ["native:40,s3:30,fuse:20,broker:10", "native", "s3:1,s3:3",
            "", "native:0", "ftp:1"]


@pytest.mark.parametrize("spec", MIXES)
def test_parse_mix_equal(spec):
    assert (_outcome(port_bench.parse_mix, spec)
            == _outcome(ref_bench.parse_mix, spec))


@pytest.mark.parametrize("spec,default", SIZES)
def test_parse_sizes_equal(spec, default):
    assert (_outcome(port_bench.parse_sizes, spec, default)
            == _outcome(ref_bench.parse_sizes, spec, default))


@pytest.mark.parametrize("spec", PERSONAS)
def test_parse_personas_equal(spec):
    assert (_outcome(port_bench.parse_personas, spec)
            == _outcome(ref_bench.parse_personas, spec))


def test_persona_tables_equal():
    assert port_bench.OPS == ref_bench.OPS
    assert port_bench.PERSONAS == ref_bench.PERSONAS
    assert port_bench.PERSONA_MIXES == ref_bench.PERSONA_MIXES
    assert port_bench._HIST_EDGES_MS == ref_bench._HIST_EDGES_MS
    for seed in range(5):
        for name in ref_bench.PERSONAS:
            assert (port_bench._persona_seed(seed, name)
                    == ref_bench._persona_seed(seed, name))


def _draws(bench, seed, s):
    """Seeded zipf draws and claims over one write log."""
    keys = bench.KeySet(s=s)
    rnd = random.Random(seed)
    for i in range(200):
        keys.add(f"3,{i:x}", 512 + (i * 37) % 4096)
    out = [keys.sample(rnd) for _ in range(300)]
    out += [keys.take(rnd) for _ in range(120)]
    out += [keys.sample(rnd) for _ in range(300)]
    out.append(len(keys))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("s", [0.8, 1.1, 2.0])
def test_keyset_zipf_draws_equal(seed, s):
    assert _draws(port_bench, seed, s) == _draws(ref_bench, seed, s)


def test_keyset_empty_and_exhausted():
    for bench in BENCH.values():
        keys = bench.KeySet()
        rnd = random.Random(3)
        assert keys.sample(rnd) is None and keys.take(rnd) is None
        keys.add("1,1", 10)
        assert keys.take(rnd) == ("1,1", 10)
        assert keys.sample(rnd) is None and len(keys) == 0


def test_phase_stats_summaries_equal():
    got = {}
    for name, bench in BENCH.items():
        st = bench.PhaseStats("read")
        rng = random.Random(5)
        for i in range(400):
            st.ok(rng.expovariate(0.2), 100 + i)
        for exc in (OSError("x"), RuntimeError("y"), OSError("z")):
            st.fail(exc)
        got[name] = (st.summary(2.5), st.attempts,
                     bench.PhaseStats("write").summary(0.0))
    assert got["port"] == got["ref"]


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return type(obj).__name__


def _reset_clients():
    for op, retry in ((ref_operation, ref_retry),
                      (port_operation, port_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


def _run(name, root):
    bench = BENCH[name]
    kw = {"device": "cpu"} if name == "port" else {}
    harness = RefHarness if name == "ref" else PortHarness
    http = ref_http if name == "ref" else port_http
    _reset_clients()
    with harness(n_volume_servers=2, volumes_per_server=10,
                 pulse_seconds=0.2, root=str(root), **kw) as c:
        c.wait_for_nodes(2)
        rc = bench.run_benchmark(
            c.master.url, n=60, concurrency=1,
            mix="write:50,read:40,delete:10", sizes="512-4096",
            seed=17, op_trace=True, collection="load",
            out=lambda *_: None,
        )
        pushed = http.get_json(f"{c.master.url}/cluster/benchmark")
    _reset_clients()
    result = bench.LAST_RESULT
    trace = bench.LAST_OP_TRACE
    phases = result["detail"]["phases"]
    return {
        "rc": rc,
        "ops": [(op, ok) for _t, op, ok in trace],
        "counts": {op: (p["ops"], p["ok"], p["failures"])
                   for op, p in phases.items()},
        "keys": _key_tree({k: v for k, v in result.items()
                           if k != "detail"}),
        "detail": {k: v for k, v in result["detail"].items()
                   if k != "phases"},
        "phase_keys": {op: sorted(p) for op, p in phases.items()},
        "pushed": sorted(pushed["benchmark"]),
        "pushed_source": pushed["benchmark"]["source"],
        "pushed_phases": pushed["benchmark"]["phases"],
    }


def test_run_benchmark_same_ops_same_result_shape(tmp_path):
    got = {name: _run(name, tmp_path / name) for name in BENCH}
    assert got["port"] == got["ref"]
    run = got["port"]
    assert run["rc"] == 0
    assert len(run["ops"]) == 60 and all(ok for _op, ok in run["ops"])
    assert {op for op, _ok in run["ops"]} == {"write", "read", "delete"}
    assert run["pushed_source"] == "push"


def test_gateway_personas_raise(tmp_path):
    """No persona raises now: the mount and broker personas, which
    raised before their tiers were ported, run as the S3 persona does
    (their front doors spawn a filer and a broker), alone and in the
    full mix, as does a native-only mix. The filer's chunks need volumes
    of their own collection, hence the slots."""
    with PortHarness(n_volume_servers=1, volumes_per_server=12,
                     pulse_seconds=0.2, root=str(tmp_path),
                     device="cpu") as c:
        c.wait_for_nodes(1)
        for personas in ("fuse:1", "broker:1",
                         "native:1,fuse:1,broker:1,s3:1"):
            rc = port_bench.run_benchmark(c.master.url, n=8, concurrency=2,
                                          personas=personas, seed=3,
                                          out=lambda *_: None)
            assert rc == 0, personas
            protocols = port_bench.LAST_RESULT["detail"]["protocols"]
            want = sorted(p.split(":")[0] for p in personas.split(","))
            assert sorted(protocols) == want
            for name, sec in protocols.items():
                assert sec["ops"] > 0 and sec["failures"] == 0, (name, sec)
        # an explicit gateway URL is used as it is: nothing spawned
        doors = port_bench.FrontDoors(c.master.url, need_s3=True,
                                      s3_url="http://x")
        assert (doors.s3_url, doors._own) == ("http://x", [])
        rc = port_bench.run_benchmark(c.master.url, n=12, concurrency=2,
                                      personas="native:50,s3:50", seed=3,
                                      out=lambda *_: None)
        assert rc == 0
        protocols = port_bench.LAST_RESULT["detail"]["protocols"]
        assert sorted(protocols) == ["native", "s3"]
        assert protocols["s3"]["ops"] > 0 and protocols["s3"]["failures"] == 0
        rc = port_bench.run_benchmark(c.master.url, n=8, concurrency=2,
                                      personas="native", seed=3,
                                      out=lambda *_: None)
    _reset_clients()
    assert rc == 0
    protocols = port_bench.LAST_RESULT["detail"]["protocols"]
    assert list(protocols) == ["native"] and protocols["native"]["ops"] > 0


def _s3_persona_run(name, root):
    """One package's S3 persona on its own cluster, filer and gateway:
    a seeded op sequence driven straight through ``run`` (the bytes of
    each op), then a seeded one-worker ``run_benchmark`` of the ``s3``
    persona (its op trace and counts)."""
    bench = BENCH[name]
    kw = {"device": "cpu"} if name == "port" else {}
    harness = RefHarness if name == "ref" else PortHarness
    _reset_clients()
    with harness(n_volume_servers=1, volumes_per_server=10,
                 pulse_seconds=0.2, root=str(root), with_s3=True,
                 **kw) as c:
        c.wait_for_nodes(1)
        persona = bench.S3Persona(c.s3.url, (512, 6000), 11)
        rnd = random.Random(11)
        direct = []
        for _ in range(30):
            op = rnd.choices(["put", "get", "list"], [0.45, 0.45, 0.1])[0]
            direct.append((op, persona.run(op, rnd)))
        rc = bench.run_benchmark(
            c.master.url, n=24, concurrency=1, personas="s3",
            sizes="512-6000", seed=5, op_trace=True, s3_url=c.s3.url,
            out=lambda *_: None)
    _reset_clients()
    proto = bench.LAST_RESULT["detail"]["protocols"]["s3"]
    return {
        "direct": direct, "rc": rc,
        "trace": [(op, ok) for _t, op, ok in
                  bench.LAST_PERSONA_TRACES["s3"]],
        "counts": (proto["ops"], proto["ok"], proto["failures"]),
        "by_op": {op: (v["ops"], v["ok"], v["failures"])
                  for op, v in proto["by_op"].items()},
    }


def test_s3_persona_matches_reference(tmp_path):
    got = {name: _s3_persona_run(name, tmp_path / name) for name in BENCH}
    assert got["port"] == got["ref"]
    run = got["port"]
    assert run["rc"] == 0 and run["counts"][2] == 0
    # multipart above MULTIPART_MIN and simple PUTs below both ran
    puts = [n for op, n in run["direct"] if op == "put"]
    assert min(puts) < port_bench.S3Persona.MULTIPART_MIN <= max(puts)
    assert {op for op, _ in run["direct"]} == {"put", "get", "list"}
