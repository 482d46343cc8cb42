"""The port's request-tracing middleware (``tracing/middleware.py``), its
``/debug/*`` plane (``telemetry/{debug,profile}.py``) and the master's
``/cluster/benchmark`` held against the reference's on the CPU.

One request sequence goes to a master of each package and one to a
volume server of each package (``device="cpu"``, no master listening):
the same statuses, the same ``/debug/*`` keys, the same trace ids
echoed, and the same request counts — in the master's own row of
``/cluster/telemetry`` and per op in each package's span histogram,
which the middleware feeds.

The counts are process-wide: every server of a package in a process
records into that package's one span histogram. So each package's
sequence runs in a fresh interpreter of its own
(``tests/_torch_middleware_child.py``), where no server that another
test left alive can add a span, and returns its answers as JSON.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_middleware_child.py")
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
N_DEBUG = 6  # the child's DEBUG paths


def _run(which, kind, tmp_path):
    """One package's sequence, from a fresh interpreter."""
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO,
        # no load-round file for either master to read
        SEAWEEDFS_LOAD_JSON=str(tmp_path / "none.json"),
    )
    proc = subprocess.run(
        [sys.executable, CHILD, which, kind, str(tmp_path / which)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _both(kind, tmp_path):
    return {which: _run(which, kind, tmp_path) for which in ("ref", "port")}


def test_master_sequence_matches_reference(tmp_path):
    got = _both("master", tmp_path)
    per_op = {which: seq[-1] for which, seq in got.items()}
    assert got["port"] == got["ref"], f"per-op counts: {per_op}"
    seq = got["port"]
    # what the sequence says, beyond agreeing
    assert [s[2] for s in seq[2:7]] == [200, 200, 200, 400, 400]
    assert seq[2][3] == {"benchmark": None}
    assert seq[4][3]["benchmark"]["ops_per_second"] == 321.5
    assert seq[4][3]["benchmark"]["p99_ms"] == 12.25
    assert seq[4][3]["benchmark"]["failures"] == 2
    assert seq[4][3]["benchmark"]["source"] == "push"
    assert seq[-3] == [200, TRACE, [[TRACE, PARENT, "master", 200]]]
    total, _errors, bench = seq[-2]
    # every request before the telemetry read was counted, once
    assert total == 8 + N_DEBUG + 2 + 2, f"per-op counts: {per_op}"
    assert bench["protocols"]["native"]["ops_s"] == 300.0


def test_volume_sequence_matches_reference(tmp_path):
    got = _both("volume", tmp_path)
    per_op = {which: seq[-1] for which, seq in got.items()}
    assert got["port"] == got["ref"], f"per-op counts: {per_op}"
    seq = got["port"]
    assert [s[2] for s in seq[:8]] == [200, 200, 200, 404, 200, 404, 200,
                                       200]
    counts = dict(seq[-1])
    assert sum(counts.values()) == 8 + N_DEBUG, f"per-op counts: {per_op}"
