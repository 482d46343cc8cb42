"""The port's benchgate (``util/benchgate.py``) held against the
reference's on every recorded round at the repository root.

Each ``BENCH_r*``, ``LOAD_r*``, ``SCALE_r*`` and ``MULTICHIP_r*`` file
is gated against every one of them as baseline through both packages:
``round_kind``, ``flatten_round``, ``gate_kind`` (its flattener's output
and its direction predicate on every flattened name),
``check_regression`` and ``compared_metrics`` must give equal answers,
exactly. The recorder-section cases of the reference's
``tests/test_recorder.py`` and the provenance stamp follow, on both
packages.
"""

import glob
import json
import os
import shutil

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.util import benchgate as ref_bg  # noqa: E402
from seaweedfs_tpu_torch.util import benchgate as port_bg  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = sorted(
    os.path.basename(p)
    for prefix in ("BENCH", "LOAD", "SCALE", "MULTICHIP")
    for p in glob.glob(os.path.join(REPO, f"{prefix}_r*.json"))
)


def _load(bg, name):
    return bg.load_round(os.path.join(REPO, name))


def _answers(bg, current, baseline, threshold):
    flatten, lib = bg.gate_kind(current, baseline)
    flat_cur, flat_base = flatten(current), flatten(baseline)
    names = sorted(set(flat_cur) | set(flat_base))
    return {
        "kind": bg.round_kind(current),
        "flat": bg.flatten_round(current),
        "gate_flat": (flat_cur, flat_base),
        "directions": [lib(n) if lib else None for n in names],
        "regression": bg.check_regression(
            current, baseline, threshold, flatten=flatten,
            lower_is_better=lib),
        "compared": bg.compared_metrics(current, baseline,
                                        flatten=flatten),
    }


def test_every_round_kind_is_present():
    kinds = {name.split("_r")[0] for name in ROUNDS}
    assert kinds == {"BENCH", "LOAD", "SCALE", "MULTICHIP"}, ROUNDS


@pytest.mark.parametrize("baseline", ROUNDS)
def test_each_round_against_each_baseline(baseline):
    base = {pkg: _load(bg, baseline)
            for pkg, bg in (("ref", ref_bg), ("port", port_bg))}
    assert base["port"] == base["ref"]
    for current in ROUNDS:
        cur = _load(ref_bg, current)
        for thr in (ref_bg.CHECK_THRESHOLD, 0.05):
            want = _answers(ref_bg, cur, base["ref"], thr)
            got = _answers(port_bg, cur, base["port"], thr)
            assert got == want, (current, baseline, thr)


@pytest.mark.parametrize("name", ROUNDS)
def test_kind_registry_and_floors(name):
    doc = _load(ref_bg, name)
    kind = ref_bg.round_kind(doc)
    assert port_bg.round_kind(doc) == kind
    for pkg in (ref_bg, port_bg):
        flatten, _lib = pkg.kind_entry(kind)
        assert flatten(doc) == pkg.flatten_round(doc)
    assert (port_bg.is_multichip_round(doc)
            == ref_bg.is_multichip_round(doc))
    if ref_bg.is_multichip_round(doc):
        assert (port_bg.multichip_floor_violations(doc)
                == ref_bg.multichip_floor_violations(doc))


def test_constants_equal():
    for name in dir(ref_bg):
        if name.isupper() and name != "ROUND_KINDS":
            assert getattr(port_bg, name) == getattr(ref_bg, name), name
    # the registry: the same kinds, in the same sniffing order
    assert ([k[0] for k in port_bg.ROUND_KINDS]
            == [k[0] for k in ref_bg.ROUND_KINDS])
    with pytest.raises(KeyError):
        port_bg.kind_entry("nonsense")


def _round_doc(p99_wait: float, backlog_peak: float) -> dict:
    return {
        "metric": "scale_converge_seconds",
        "value": 5.0,
        "unit": "s",
        "detail": {
            "converge_seconds": 5.0,
            "telemetry_poll_p99_ms": 10.0,
            "load_failure_rate": 0.0,
            "contention": {"sites": 3, "total_wait_s": 1.0,
                           "p99_wait_s": p99_wait, "top": []},
            "timeline": {"hz": 4.0, "frames": 20,
                         "peaks": {"repair_backlog": backlog_peak}},
        },
    }


@pytest.fixture(params=["ref", "port"])
def bg(request):
    return {"ref": ref_bg, "port": port_bg}[request.param]


class TestRecorderSections:
    def test_flatten_carries_recorder_sections(self, bg):
        flat = bg.flatten_scale(_round_doc(2.5, 120.0))
        assert flat["detail.contention.p99_wait_s"] == 2.5
        assert flat["detail.timeline.peak_repair_backlog"] == 120.0

    def test_floors_damp_noise(self, bg):
        flat = bg.flatten_scale(_round_doc(0.0001, 2.0))
        assert (flat["detail.contention.p99_wait_s"]
                == bg.SCALE_LOCK_WAIT_FLOOR)
        assert (flat["detail.timeline.peak_repair_backlog"]
                == bg.SCALE_REPAIR_BACKLOG_FLOOR)

    def test_regression_fires_on_rise_only(self, bg):
        base, worse = _round_doc(1.0, 100.0), _round_doc(5.0, 300.0)
        kw = dict(flatten=bg.flatten_scale,
                  lower_is_better=bg.scale_lower_is_better)
        msgs = bg.check_regression(worse, base, **kw)
        assert any("contention.p99_wait_s" in m for m in msgs), msgs
        assert any("peak_repair_backlog" in m for m in msgs), msgs
        assert bg.check_regression(base, worse, **kw) == []

    def test_resource_peaks_flatten_floored_and_directed(self, bg):
        def doc(fds, threads):
            d = _round_doc(0.01, 100.0)
            d["detail"]["timeline"]["peaks"].update(fds=fds,
                                                   threads=threads)
            return d

        flat = bg.flatten_scale(doc(900.0, 320.0))
        assert flat["detail.timeline.peak_fds"] == 900.0
        assert flat["detail.timeline.peak_threads"] == 320.0
        flat = bg.flatten_scale(doc(40.0, 12.0))
        assert flat["detail.timeline.peak_fds"] == bg.SCALE_FD_PEAK_FLOOR
        assert (flat["detail.timeline.peak_threads"]
                == bg.SCALE_THREAD_PEAK_FLOOR)
        msgs = bg.check_regression(
            doc(2400.0, 900.0), doc(800.0, 300.0),
            flatten=bg.flatten_scale,
            lower_is_better=bg.scale_lower_is_better)
        assert any("peak_fds" in m for m in msgs), msgs


def test_provenance_stamps_equal(tmp_path, monkeypatch):
    """``round_files`` and ``stamp_provenance`` over a directory holding
    every recorded round: the same sequence numbers and PR tags."""
    for name in ROUNDS:
        shutil.copy(os.path.join(REPO, name), tmp_path / name)
    (tmp_path / "SCALE_r99.txt").write_text("{}")
    monkeypatch.setenv("SEAWEEDFS_ROUND_PR", "7")
    for prefix in ("", "BENCH", "LOAD", "SCALE", "MULTICHIP"):
        assert (port_bg.round_files(str(tmp_path), prefix)
                == ref_bg.round_files(str(tmp_path), prefix))
        if prefix:
            got = [bg.stamp_provenance({"value": 1}, str(tmp_path), prefix)
                   for bg in (ref_bg, port_bg)]
            assert got[0] == got[1] and got[0]["pr"] == "7"
    driver = tmp_path / "wrapped.json"
    driver.write_text(json.dumps({"parsed": {"value": 3.0}}))
    assert port_bg.load_round(str(driver)) == {"value": 3.0}
