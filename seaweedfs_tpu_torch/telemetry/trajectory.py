"""Cross-round trajectory plane: every recorded *_rNN.json, one view.

Pairwise ``--check`` gates (bench.py, `weed scale -check`,
`weed benchmark -check`) only ever compare TWO rounds, so a metric can
decay 15% per PR forever without tripping a 20% gate. This module
loads the full trajectory — every BENCH/LOAD/SCALE/MULTICHIP round
file, flattened through the util/benchgate.py kind registry, ordered
by the ``recorded_seq`` provenance stamp — renders per-metric
sparkline tables (`weed trends`), and detects **drift**: monotonic
multi-round decay (a trailing streak of adverse moves) or cumulative
decline past the pairwise threshold since the best round
(`weed trends --check` exits 1).

Drift is judged inside a COMPARABLE SEGMENT, not across the whole
kind: a SCALE round's numbers depend on its churn profile and a
MULTICHIP round's on its dispatch path, so rounds are grouped by
those recorded parameters first — a flat-churn round never drifts
against a warm-tier round, and a staged-lanes sweep never drifts
against a legacy-dispatch one.

The port's copy of ``seaweedfs_tpu/telemetry/trajectory.py``, with the
same ``_ROUND_RE``, so ``weed trends`` renders the repository's recorded
rounds as the reference's does.
"""

from __future__ import annotations

import os
import re

from ..util import benchgate

# at least this many rounds in a segment before drift can fire at
# all: two points are a pairwise check (which already exists), not a
# trajectory
MIN_ROUNDS = 3

# trailing streak rule: this many CONSECUTIVE adverse moves at the
# end of a series, each at least STREAK_EPS relative, is drift even
# when the cumulative decline is still under the pairwise threshold
DRIFT_STREAK = 3
STREAK_EPS = 0.03

_ROUND_RE = re.compile(r"^(BENCH|LOAD|SCALE|MULTICHIP)_r(\d+)\.json$")


def load_rounds(dir_path: str = ".") -> list[dict]:
    """Every parseable round file in ``dir_path`` as
    ``{kind, file, file_seq, seq, result, flat}``, ordered per kind by
    recorded_seq (legacy rounds without a stamp order by their
    filename number — the backfilled convention)."""
    rounds: list[dict] = []
    try:
        names = sorted(os.listdir(dir_path or "."))
    except OSError:
        return rounds
    for name in names:
        m = _ROUND_RE.match(name)
        if not m:
            continue
        path = os.path.join(dir_path or ".", name)
        try:
            result = benchgate.load_round(path)
        except (OSError, ValueError):
            continue
        if not isinstance(result, dict):
            continue
        file_seq = int(m.group(2))
        seq = result.get("recorded_seq")
        if not isinstance(seq, int):
            seq = file_seq
        rounds.append({
            "kind": m.group(1),
            "file": name,
            "file_seq": file_seq,
            "seq": seq,
            "result": result,
            "flat": benchgate.flatten_round(result),
        })
    rounds.sort(key=lambda r: (r["kind"], r["seq"], r["file_seq"]))
    return rounds


def segment_of(kind: str, result: dict) -> str:
    """The comparability segment of one round: SCALE rounds split by
    churn profile, MULTICHIP rounds by the recorded dispatch path;
    BENCH/LOAD rounds form one segment per kind."""
    detail = result.get("detail") or {}
    if kind == "SCALE":
        return str((detail.get("churn") or {}).get("kind") or "?")
    if kind == "MULTICHIP":
        return str(detail.get("dispatch") or "pre-dispatch")
    return ""


def _lower_is_better(kind: str):
    registry_kind = {
        "BENCH": "bench", "LOAD": "load",
        "SCALE": "scale", "MULTICHIP": "multichip",
    }[kind]
    _flatten, lib = benchgate.kind_entry(registry_kind)
    return lib


def build_series(
    rounds: list[dict],
) -> dict[tuple[str, str, str], list[tuple[int, float]]]:
    """(kind, segment, metric) → ordered [(seq, value), ...] over the
    rounds where the metric was recorded."""
    series: dict[tuple[str, str, str], list[tuple[int, float]]] = {}
    for r in rounds:
        seg = segment_of(r["kind"], r["result"])
        for metric, v in r["flat"].items():
            series.setdefault((r["kind"], seg, metric), []).append(
                (r["seq"], v)
            )
    return series


def detect_drift(
    rounds: list[dict],
    threshold: float = benchgate.CHECK_THRESHOLD,
    min_rounds: int = MIN_ROUNDS,
) -> list[dict]:
    """Every (kind, segment, metric) series whose tail drifts: a
    trailing streak of >= DRIFT_STREAK adverse moves (each over
    STREAK_EPS), or a cumulative adverse change >= ``threshold``
    between the series' BEST round and its latest. Values arrive
    noise-floored by the flatteners, so sub-floor wobble never moves.
    """
    out: list[dict] = []
    for (kind, seg, metric), pts in sorted(
        build_series(rounds).items()
    ):
        if len(pts) < min_rounds:
            continue
        vals = [v for _seq, v in pts]
        lib = _lower_is_better(kind)
        lower = bool(lib(metric)) if lib is not None else False

        def adverse(frm: float, to: float) -> float:
            """Relative adverse move from ``frm`` to ``to`` (positive
            = worse); 0 when the reference is non-positive."""
            if frm <= 0:
                return 0.0
            return (to - frm) / frm if lower else (frm - to) / frm

        streak = 0
        for prev, cur in zip(vals[-2::-1], vals[::-1]):
            if adverse(prev, cur) >= STREAK_EPS:
                streak += 1
            else:
                break
        best = min(vals) if lower else max(vals)
        cumulative = adverse(best, vals[-1])
        if streak >= DRIFT_STREAK or cumulative >= threshold:
            out.append({
                "kind": kind,
                "segment": seg,
                "metric": metric,
                "rounds": len(vals),
                "streak": streak,
                "cumulative": round(cumulative, 4),
                "best": best,
                "latest": vals[-1],
                "rule": (
                    "streak" if streak >= DRIFT_STREAK else "cumulative"
                ),
            })
    return out


def render(
    rounds: list[dict],
    drifts: list[dict] | None = None,
    threshold: float = benchgate.CHECK_THRESHOLD,
) -> str:
    """The `weed trends` report: per kind/segment, one sparkline row
    per metric (reusing cluster.timeline's renderer) with first/last
    values, drift rows flagged."""
    from ..shell.command_cluster import _sparkline

    if drifts is None:
        drifts = detect_drift(rounds, threshold=threshold)
    drifted = {
        (d["kind"], d["segment"], d["metric"]): d for d in drifts
    }
    lines: list[str] = []
    if not rounds:
        return "no *_rNN.json round files found\n"
    series = build_series(rounds)
    by_group: dict[tuple[str, str], list[tuple[str, list]]] = {}
    for (kind, seg, metric), pts in sorted(series.items()):
        by_group.setdefault((kind, seg), []).append((metric, pts))
    counted: dict[tuple[str, str], int] = {}
    for r in rounds:
        key = (r["kind"], segment_of(r["kind"], r["result"]))
        counted[key] = counted.get(key, 0) + 1
    for (kind, seg), metrics in sorted(by_group.items()):
        label = f"{kind}" + (f" [{seg}]" if seg else "")
        lines.append(
            f"{label}: {counted.get((kind, seg), 0)} rounds"
        )
        width = max(len(m) for m, _ in metrics)
        for metric, pts in metrics:
            vals = [v for _seq, v in pts]
            mark = ""
            d = drifted.get((kind, seg, metric))
            if d is not None:
                mark = (
                    f"  DRIFT({d['rule']}: "
                    f"{100 * d['cumulative']:.0f}% from best, "
                    f"streak {d['streak']})"
                )
            spark = _sparkline(vals, cells=24)
            lines.append(
                f"  {metric:<{width}} {spark:<24} "
                f"{vals[0]:g} -> {vals[-1]:g} "
                f"({len(vals)}r){mark}"
            )
        lines.append("")
    if drifts:
        lines.append(
            f"DRIFT: {len(drifts)} series decaying across rounds "
            f"(threshold {threshold:.0%}, streak {DRIFT_STREAK})"
        )
    else:
        lines.append(
            f"no drift: every series within {threshold:.0%} of its "
            f"best round, no {DRIFT_STREAK}-round decay streak"
        )
    return "\n".join(lines) + "\n"


def run_trends(
    dir_path: str = ".",
    check: bool = False,
    threshold: float | None = None,
    out=print,
) -> int:
    """The `weed trends` entry: render the trajectory; with ``check``
    exit 1 when any series drifts (the CI cadence gate)."""
    thr = (
        threshold if threshold is not None
        else benchgate.CHECK_THRESHOLD
    )
    rounds = load_rounds(dir_path)
    drifts = detect_drift(rounds, threshold=thr)
    out(render(rounds, drifts=drifts, threshold=thr).rstrip("\n"))
    if check and drifts:
        return 1
    return 0
