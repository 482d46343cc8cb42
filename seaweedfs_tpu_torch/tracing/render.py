"""Span-tree rendering (the port's copy of
``seaweedfs_tpu/tracing/render.py``): one indented line per span,
children under parents in start order, so a request reads as

    trace 7f3a9c...
      s3.PutObject 12.41ms
        filer.write 11.02ms
          master.assign 0.83ms
          volume.write 3.20ms
            codec.encode(native,4x10) 0.45ms 1.2 GB/s
"""

from __future__ import annotations


def _as_dicts(spans) -> list[dict]:
    return [
        s.to_dict() if hasattr(s, "to_dict") else dict(s)
        for s in spans
    ]


def render_tree(spans) -> str:
    """Render spans (Span objects or /debug/traces dicts) as indented
    trees, grouped by trace id. Orphans (parent span not in the set —
    e.g. evicted from the ring) render as extra roots of their trace."""
    dicts = _as_dicts(spans)
    if not dicts:
        return "no spans\n"
    by_id = {s["span_id"]: s for s in dicts}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in dicts:
        pid = s.get("parent_id") or ""
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    lines: list[str] = []

    def walk(s: dict, depth: int) -> None:
        attrs = s.get("attrs") or {}
        extra = ""
        if "gbps" in attrs:
            extra = f" {attrs['gbps']} GB/s"
        status = s.get("status") or 0
        flag = f" !{status}" if status >= 400 else ""
        lines.append(
            f"{'  ' * depth}{s['component']}.{s['op']} "
            f"{s['duration'] * 1e3:.2f}ms{flag}{extra}"
        )
        for c in sorted(
            children.get(s["span_id"], []), key=lambda x: x["start"]
        ):
            walk(c, depth + 1)

    # group roots per trace, traces ordered by their earliest root
    by_trace: dict[str, list[dict]] = {}
    for r in roots:
        by_trace.setdefault(r["trace_id"], []).append(r)
    for tid, trace_roots in sorted(
        by_trace.items(), key=lambda kv: min(r["start"] for r in kv[1])
    ):
        lines.append(f"trace {tid}")
        for r in sorted(trace_roots, key=lambda x: x["start"]):
            walk(r, 1)
    return "\n".join(lines) + "\n"
