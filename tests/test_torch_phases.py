"""The port's PhaseTimer against the reference's: under the same
injected times, ``finish()`` gives identical summaries, one identical
span per phase under the creating span, identical
``seaweedfs_phase_seconds`` text, and identical ``summarize_line`` and
``render_waterfall`` output."""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu import tracing as ref_tracing  # noqa: E402
from seaweedfs_tpu.stats import metrics as ref_metrics  # noqa: E402
from seaweedfs_tpu.telemetry import phases as ref_phases  # noqa: E402
from seaweedfs_tpu_torch import tracing  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics  # noqa: E402
from seaweedfs_tpu_torch.telemetry import phases  # noqa: E402

SIDES = ((phases, tracing, metrics), (ref_phases, ref_tracing, ref_metrics))

RUNS = {  # name -> (op, [(phase, seconds, bytes)], notes, wall seconds)
    "encode": ("ec.encode",
               [("read", 0.395125, 1 << 30), ("stage", 0.0021, 0),
                ("h2d", 0.5391, 1 << 30), ("codec", 0.0693, 1 << 30),
                ("write", 0.886, 1503238553), ("read", 0.0001, 512),
                ("flush", 0.0223, 0)],
               {"batch_bytes": 1 << 20, "pipeline_depth": 3}, 1.0971234),
    "batch": ("ec.encode.batch",
              [("read", 0.2, 100), ("codec", 0.00004, 7)],
              {"readers": 4}, 0.5),
    "empty": ("ec.rebuild", [], {}, 0.0),
    "tiny": ("ec.decode", [("write", 1e-7, 0)], {}, 3e-7),
}


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` stands still until a test moves it."""
    now = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    return now


@pytest.fixture
def fresh(monkeypatch):
    """A fresh phase histogram and span ring on each side."""
    for ph, tr, mt in SIDES:
        monkeypatch.setattr(ph, "PHASE_SECONDS", mt.Histogram(
            "seaweedfs_phase_seconds",
            "Busy seconds per pipeline phase of a multi-stage operation.",
            ("op", "phase")))
        monkeypatch.setattr(tr.recorder, "RECORDER", tr.SpanRecorder())


def run(side, name, clock):
    ph, tr, _ = side
    op, adds, notes, wall = RUNS[name]
    with tr.start_span("ec", "generate") as root:
        clock[0] = 1000.0
        pt = ph.PhaseTimer(op)
    for phase, secs, n in adds:
        pt.add(phase, secs, n)
    for key, value in notes.items():
        pt.note(key, value)
    clock[0] = 1000.0 + wall
    summary = pt.finish()
    clock[0] += 5.0  # later reads see the frozen wall
    assert pt.wall() == pytest.approx(wall)
    spans = [(s.component, s.op, s.duration, s.attrs,
              s.parent_id == root.span_id, s.trace_id == root.trace_id)
             for s in tr.recorder.RECORDER.spans() if s is not root]
    return summary, spans, "\n".join(ph.PHASE_SECONDS.expose())


@pytest.mark.parametrize("name", list(RUNS))
def test_finish_matches_reference(name, clock, fresh):
    (got, got_spans, got_text), (want, want_spans, want_text) = (
        run(side, name, clock) for side in SIDES)
    assert got == want
    assert got_spans == want_spans
    assert got_text == want_text
    phase_names = {p for p, _, _ in RUNS[name][1]}
    assert len(got_spans) == len(phase_names)
    assert all(parented for *_, parented, _ in got_spans)
    assert got_text.count("_count{") == len(phase_names)


@pytest.mark.parametrize("name", list(RUNS))
def test_summary_lines_match_reference(name, clock, fresh):
    got, _, _ = run(SIDES[0], name, clock)
    want, _, _ = run(SIDES[1], name, clock)
    for summary in (got, want):
        assert phases.summarize_line(summary) == \
            ref_phases.summarize_line(summary)
        assert phases.render_waterfall(summary) == \
            ref_phases.render_waterfall(summary)
    assert phases.render_waterfall(got) == ref_phases.render_waterfall(want)


@pytest.mark.parametrize("name", list(RUNS))
def test_totals_match_reference(name, clock, fresh):
    """``totals()`` is each phase's summed seconds, before ``finish()``
    and after it."""
    got = []
    for ph, _, _ in SIDES:
        op, adds, _, wall = RUNS[name]
        pt = ph.PhaseTimer(op)
        for phase, secs, n in adds:
            pt.add(phase, secs, n)
        before = pt.totals()
        clock[0] += wall
        pt.finish()
        assert pt.totals() == before
        got.append(before)
    assert got[0] == got[1]
    assert sorted(got[0]) == sorted({p for p, _, _ in RUNS[name][1]})


def test_explicit_parent_and_no_parent(clock, fresh):
    """An explicit ``parent_span`` wins over the active span; a timer
    made outside any span records no span but still observes."""
    for ph, tr, _ in SIDES:
        parent = tr.Span("ec", "elsewhere")
        with tr.start_span("ec", "active"):
            pt = ph.PhaseTimer("ec.encode", parent_span=parent)
        pt.add("read", 0.5)
        pt.finish()
        orphan = ph.PhaseTimer("ec.encode")
        orphan.add("write", 0.25)
        orphan.finish()
        phase_spans = [s for s in tr.recorder.RECORDER.spans()
                       if s.component == "phase"]
        assert [(s.op, s.parent_id) for s in phase_spans] == [
            ("ec.encode.read", parent.span_id)]
        snap = ph.PHASE_SECONDS.snapshot()
        assert sorted(snap) == [("ec.encode", "read"),
                                ("ec.encode", "write")]


def test_summary_before_finish_exports_nothing(clock, fresh):
    pt = phases.PhaseTimer("ec.encode")
    pt.add("read", 0.1, 10)
    clock[0] += 2.0
    s = pt.summary()
    assert s["wall_seconds"] == 2.0 and s["phases"]["read"]["bytes"] == 10
    assert phases.PHASE_SECONDS.snapshot() == {}
    clock[0] += 1.0
    assert pt.finish()["wall_seconds"] == 3.0
    assert pt.summary()["wall_seconds"] == 3.0


def test_threads_accumulate(fresh):
    """Pipeline stages add from their own threads; no add is lost."""
    pt = phases.PhaseTimer("ec.encode")

    def worker():
        for _ in range(500):
            with pt.phase("codec", 1):
                pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    info = pt.finish()["phases"]["codec"]
    assert info["count"] == 4000 and info["bytes"] == 4000
