"""The port's tracing against the reference's: the same headers and
spans give the same ``traceparent`` parsing, injection and extraction,
the same parenting of recorded spans, and the same rendered trees."""

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu import tracing as ref_tracing  # noqa: E402
from seaweedfs_tpu_torch import tracing  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics  # noqa: E402

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN = "00f067aa0ba902b7"

HEADERS = {
    "valid": f"00-{TRACE}-{SPAN}-01",
    "upper": f"00-{TRACE.upper()}-{SPAN.upper()}-01",
    "padded": f"  00-{TRACE}-{SPAN}-00 ",
    "zero trace": f"00-{'0' * 32}-{SPAN}-01",
    "zero span": f"00-{TRACE}-{'0' * 16}-01",
    "short span": f"00-{TRACE}-{SPAN[:-1]}-01",
    "no flags": f"00-{TRACE}-{SPAN}",
    "not hex": f"00-{TRACE[:-1]}g-{SPAN}-01",
    "empty": "",
}


@pytest.mark.parametrize("name", list(HEADERS))
def test_parse_traceparent_matches_reference(name):
    value = HEADERS[name]
    assert tracing.parse_traceparent(value) == \
        ref_tracing.parse_traceparent(value)
    for key in ("traceparent", "TraceParent", "x-other"):
        assert tracing.extract({key: value}) == \
            ref_tracing.extract({key: value})


def test_inject_and_attach_match_reference():
    for pkg in (tracing, ref_tracing):
        assert pkg.current() is None
        assert pkg.inject({}) == {}  # untraced: nothing added
        span = pkg.Span("codec", "encode", trace_id=TRACE)
        span.span_id = SPAN
        with pkg.attach(span):
            assert pkg.current() is span
            headers = pkg.inject({"a": "b"})
            pkg.set_op("rebuild")
            # an existing header is kept
            kept = pkg.inject({"traceparent": "x"})
        assert pkg.current() is None
        assert headers == {"a": "b",
                           "traceparent": f"00-{TRACE}-{SPAN}-01"}
        assert kept == {"traceparent": "x"}
        assert span.op == "rebuild"
        assert pkg.extract(headers) == (TRACE, SPAN)


def test_record_span_parenting_matches_reference(monkeypatch):
    """A recorded span hangs under the given parent, else the thread's
    active span, else nowhere (nothing recorded)."""
    for pkg in (tracing, ref_tracing):
        assert pkg.record_span("codec", "encode(x,4x10)", 0.5) is None
    got = {}
    for name, pkg in (("port", tracing), ("ref", ref_tracing)):
        rec = pkg.SpanRecorder()
        monkeypatch.setattr(pkg.recorder, "RECORDER", rec)
        with pkg.start_span("ec", "encode") as root:
            child = pkg.record_span(
                "codec", "encode(cuda,4x10)", 0.25, attrs={"gbps": 1.5})
            explicit = pkg.record_span("phase", "ec.encode.read", 0.125,
                                       parent=root)
            with pkg.start_span("ec", "inner") as inner:
                assert pkg.current() is inner
            assert pkg.current() is root
        assert pkg.current() is None
        assert child.parent_id == explicit.parent_id == root.span_id
        assert inner.parent_id == root.span_id
        assert {s.trace_id for s in rec.spans()} == {root.trace_id}
        assert rec.spans(trace_id="other") == []
        got[name] = [(s.component, s.op, s.attrs,
                      s.parent_id == root.span_id)
                     for s in rec.spans()]
        assert [s.duration for s in rec.spans()][:2] == [0.25, 0.125]
        assert len(rec.spans(limit=2)) == 2
    assert got["port"] == got["ref"]


def test_span_errors_and_histogram_go_to_the_port_registry(monkeypatch):
    port_hist = metrics.Histogram("seaweedfs_trace_span_seconds", "",
                                  ("component", "op"))
    monkeypatch.setattr(tracing.recorder, "SPAN_SECONDS", port_hist)
    monkeypatch.setattr(tracing.recorder, "RECORDER",
                        tracing.SpanRecorder())
    with pytest.raises(RuntimeError):
        with tracing.start_span("codec", "encode") as span:
            raise RuntimeError("boom")
    assert span.status == 500 and span.duration > 0
    tracing.finish(span, 200)  # idempotent: the first finish stands
    assert span.status == 500
    assert list(port_hist.snapshot()) == [("codec", "encode")]


def _tree(pkg):
    """The same spans, built with one package's ``Span``."""
    # (span id, parent id, trace, component, op, start, seconds, status,
    # attrs)
    specs = [
        ("a1", "", "t1", "s3", "PutObject", 10.0, 0.01241, 200, {}),
        ("b1", "a1", "t1", "filer", "write", 10.001, 0.01102, 200, {}),
        ("c1", "b1", "t1", "volume", "write", 10.003, 0.0032, 503, {}),
        ("c2", "b1", "t1", "master", "assign", 10.002, 0.00083, 0, {}),
        ("d1", "c1", "t1", "codec", "encode(cuda,4x10)", 10.004, 0.00045,
         0, {"gbps": 1.2}),
        ("z9", "gone", "t1", "codec", "encode(native,4x10)", 10.5, 0.002,
         0, {"bytes": 7}),
        ("e1", "", "t0", "ec", "rebuild", 9.0, 1.5, 404, {}),
    ]
    out = []
    for sid, pid, tid, comp, op, start, dur, status, attrs in specs:
        s = pkg.Span(comp, op, trace_id=tid, parent_id=pid)
        s.span_id, s.start, s.duration, s.status = sid, start, dur, status
        s.attrs.update(attrs)
        out.append(s)
    return out


def test_render_tree_matches_reference():
    port, ref = _tree(tracing), _tree(ref_tracing)
    text = tracing.render_tree(port)
    assert text == ref_tracing.render_tree(ref)
    # and from dicts, as a ring's snapshot is served
    assert tracing.render_tree([s.to_dict() for s in port]) == text
    assert text.splitlines()[0] == "trace t0"
    assert "      codec.encode(cuda,4x10) 0.45ms 1.2 GB/s" in text
    assert tracing.render_tree([]) == ref_tracing.render_tree([])


def test_new_ids_are_well_formed():
    for _ in range(50):
        tid, sid = tracing.new_trace_id(), tracing.new_span_id()
        assert len(tid) == 32 and len(sid) == 16
        assert tracing.parse_traceparent(f"00-{tid}-{sid}-01") == (tid, sid)
