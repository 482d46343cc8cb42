"""JSON filtering/projection over stored blobs.

Behavioral model: weed/query/json/query_json.go:17-30 +
weed/server/volume_grpc_query.go:13-62 — the S3-Select seed: a dotted
field path, a comparison op, and a projection list applied to every
JSON document in a needle (one object, or newline-delimited objects).

The port's copy of ``seaweedfs_tpu/query/json_query.py``.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

_OPS = {
    "=": lambda a, b: a == b,
    "eq": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "ne": lambda a, b: a != b,
    ">": lambda a, b: a is not None and a > b,
    "gt": lambda a, b: a is not None and a > b,
    ">=": lambda a, b: a is not None and a >= b,
    "ge": lambda a, b: a is not None and a >= b,
    "<": lambda a, b: a is not None and a < b,
    "lt": lambda a, b: a is not None and a < b,
    "<=": lambda a, b: a is not None and a <= b,
    "le": lambda a, b: a is not None and a <= b,
    "contains": lambda a, b: isinstance(a, str) and b in a,
    "prefix": lambda a, b: isinstance(a, str) and a.startswith(b),
}


def get_path(doc: Any, path: str) -> Any:
    """Dotted path lookup: "a.b.0.c" (gjson-style, list indices ok)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


def apply_filter(doc: Any, flt: dict | None) -> bool:
    """flt = {"field": "a.b", "op": ">=", "value": 10} (None ⇒ match)."""
    if not flt:
        return True
    op = _OPS.get(flt.get("op", "="))
    if op is None:
        raise ValueError(f"unknown op {flt.get('op')!r}")
    return bool(op(get_path(doc, flt["field"]), flt.get("value")))


def project(doc: Any, projections: list[str] | None) -> Any:
    if not projections:
        return doc
    return {p: get_path(doc, p) for p in projections}


def query_json_lines(
    blob: bytes,
    flt: dict | None = None,
    projections: list[str] | None = None,
) -> Iterator[dict]:
    """Run filter+projection over one object or NDJSON lines."""
    text = blob.decode("utf8", "replace").strip()
    if not text:
        return
    docs: list[Any]
    try:
        parsed = json.loads(text)
        docs = parsed if isinstance(parsed, list) else [parsed]
    except json.JSONDecodeError:
        docs = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                docs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    for doc in docs:
        if apply_filter(doc, flt):
            yield project(doc, projections)
