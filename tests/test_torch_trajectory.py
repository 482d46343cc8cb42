"""The port's ``telemetry/trajectory.py`` (``weed trends``) held against
the reference's on the CPU: the repository's own recorded rounds render
to the same text with the same exit code, and so do synthetic
trajectories that drift, one for each drift rule.
"""

import json
import os

import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.command import cli as ref_cli  # noqa: E402
from seaweedfs_tpu.telemetry import trajectory as ref_traj  # noqa: E402
from seaweedfs_tpu_torch.command import cli as port_cli  # noqa: E402
from seaweedfs_tpu_torch.telemetry import trajectory as port_traj  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = {"ref": ref_traj, "port": port_traj}


def _trends(which, **kw):
    lines = []
    rc = TRAJ[which].run_trends(out=lines.append, **kw)
    return rc, "\n".join(lines)


def test_round_pattern_is_the_reference_s():
    assert port_traj._ROUND_RE.pattern == ref_traj._ROUND_RE.pattern


@pytest.mark.parametrize("check", [False, True])
def test_repository_rounds_render_like_the_reference(check):
    got = {which: _trends(which, dir_path=REPO, check=check)
           for which in TRAJ}
    assert got["port"] == got["ref"]
    rc, text = got["port"]
    assert rc == 0 and "SCALE" in text and "BENCH" in text
    rounds = port_traj.load_rounds(REPO)
    assert len(rounds) == len(ref_traj.load_rounds(REPO)) > 10


def _scale(converge, seq, churn="flat"):
    return {"metric": "scale_converge_seconds", "value": converge,
            "recorded_seq": seq,
            "detail": {"converge_seconds": converge,
                       "churn": {"kind": churn}}}


def _load(ops, seq):
    return {"metric": "load_ops_per_second", "value": ops,
            "recorded_seq": seq, "detail": {}}


TRAJECTORIES = {
    # a trailing streak of adverse moves
    "streak": [("SCALE", _scale(10.0 + 3 * i, i)) for i in range(5)],
    # one fall past the threshold since the best round
    "cumulative": [("LOAD", _load(v, i)) for i, v in
                   enumerate((500.0, 510.0, 505.0, 300.0))],
    # segments that must not drift against each other
    "segments": [("SCALE", _scale(5.0, 1, "flat")),
                 ("SCALE", _scale(40.0, 2, "warm")),
                 ("SCALE", _scale(5.1, 3, "flat")),
                 ("LOAD", _load(480.0, 4))],
    "flat": [("LOAD", _load(500.0 + i, i)) for i in range(4)],
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
@pytest.mark.parametrize("threshold", [None, 0.5])
def test_drift_matches_reference(name, threshold, tmp_path):
    for i, (kind, doc) in enumerate(TRAJECTORIES[name]):
        (tmp_path / f"{kind}_r{i + 1:02d}.json").write_text(json.dumps(doc))
    got = {which: _trends(which, dir_path=str(tmp_path), check=True,
                          threshold=threshold)
           for which in TRAJ}
    assert got["port"] == got["ref"]
    if name in ("segments", "flat"):
        assert got["port"][0] == 0
    if name == "streak":
        assert got["port"][0] == 1


def test_weed_trends_matches_reference(capsys):
    rcs = []
    texts = []
    for cli in (ref_cli, port_cli):
        rcs.append(cli.main(["trends", "-dir", REPO, "-check"]))
        texts.append(capsys.readouterr().out)
    assert rcs == [0, 0] and texts[0] == texts[1] and texts[0].strip()
