"""Per-device dispatch ledger + scaling-efficiency decomposer.

The port's counterpart of ``seaweedfs_tpu/telemetry/devices.py``. It
answers where a dispatch's wall time went, per device position, before
anyone claims a scaling win. The ledger wraps the dispatch layer at two
seams:

* **sharded paths** (``parallel/ec_sharded.py``) call
  :meth:`DeviceLedger.observe_sharded` on their output
  (``ec_sharded.ShardedArray``): each position's ready event is waited
  on in turn, on the host clock from one start, so compute-busy is the
  measured wait for THAT position's tile, never the launch-only time
  the enqueue returns in. The per-dispatch ready spread (max−min) is the
  imbalance signal; sequential waiting makes it a lower bound, the
  honest direction for a gate. Rows are labelled by mesh position
  (``"0"`` … ``"N-1"``), since positions on one card share its device
  index;
* **codec dispatches** arrive through the ``ops/profiler.py`` bridge
  (:meth:`DeviceLedger.on_codec_dispatch`): the ``cuda`` backend's
  dispatches attribute wall-incl-sync seconds (staging, H2D, kernel and
  the D2H wait) and input bytes to the default device's row, ``"0"``;
  the native host codec and the plain version (``cpu``) are not device
  work and are ignored.

Host staging lanes are fed by the slab readers of
``storage/erasure_coding/encoder.py`` (one lane per volume reader) and
by ``ec_sharded.stage_lanes`` (one lane ``d<position>`` per position).
H2D/D2H seconds are *estimates* from the byte counts and the
``ops/link.py`` probe bandwidths. Everything is exposed as bounded-label
metrics of the port's registry (``seaweedfs_device_busy_seconds{device}``
and four more families; lane labels are clamped), as
:meth:`DeviceLedger.snapshot` / :meth:`DeviceLedger.summary` (served at
``/debug/devices``) and as identity-matched flight-recorder probes
(:func:`install_probes`).

On top of the ledger, :func:`decompose_scaling` turns the 1→N scaling
gap into named fractions (serial host, launch serialization, transfer,
imbalance, compute serialization, and the collective residual) that sum
to 1.0 by construction.
"""

from __future__ import annotations

import threading
import time

from ..ops import link
from ..stats.metrics import REGISTRY

# The reference's name and help text, kept so the exposition matches;
# what it sums here is each card dispatch's wall seconds on the host
# clock, launch to result(). The card's own busy or idle share comes
# from a torch.profiler trace, never from this family.
DEVICE_BUSY_SECONDS = REGISTRY.counter(
    "seaweedfs_device_busy_seconds",
    "Per-device compute-busy seconds (timed to each dispatch's "
    "result, never launch-only)",
    labels=("device",),
)
DEVICE_DISPATCH_TOTAL = REGISTRY.counter(
    "seaweedfs_device_dispatch_total",
    "Dispatches attributed per device by the dispatch ledger",
    labels=("device",),
)
DEVICE_TRANSFER_BYTES = REGISTRY.counter(
    "seaweedfs_device_transfer_bytes_total",
    "Bytes staged to (h2d) / fetched from (d2h) each device",
    labels=("device", "direction"),
)
DEVICE_LAUNCH_SECONDS = REGISTRY.counter(
    "seaweedfs_device_launch_seconds",
    "Host-side dispatch-launch serialization seconds per device "
    "(the enqueue cost every device's work serializes behind)",
    labels=("device",),
)
STAGING_LANE_SECONDS = REGISTRY.counter(
    "seaweedfs_staging_lane_busy_seconds",
    "Host staging-lane (slab-ring reader) busy seconds",
    labels=("lane",),
)

# the backend the codec seam runs on the card (ops/codec.py)
_DEVICE_BACKENDS = {"cuda"}
# staging-lane labels stay bounded even if a batch fields hundreds of
# volume readers: lanes past the cap share one overflow label
_LANE_CAP = 16

# the cluster.health threshold: a (max-min) busy spread above this
# fraction of the mean is worth a devices: line on the health screen
IMBALANCE_THRESHOLD = 0.20


def _lane_label(lane) -> str:
    try:
        i = int(lane)
    except (TypeError, ValueError):
        return str(lane)
    return str(i) if 0 <= i < _LANE_CAP else f"{_LANE_CAP}+"


def _transfer_estimates() -> tuple[float | None, float | None]:
    """(h2d_gbps, d2h_gbps) from the link probe, if it has run.

    Side-effect-free on purpose: the ledger must never trigger a link
    probe from inside a dispatch it is attributing."""
    res = link.STATE.probe_result or {}
    return res.get("h2d_gbps"), res.get("d2h_gbps")


def _device_row() -> dict:
    return {
        "busy_s": 0.0,
        "dispatches": 0,
        "launch_s": 0.0,
        "h2d_bytes": 0,
        "d2h_bytes": 0,
        "h2d_s_est": 0.0,
        "d2h_s_est": 0.0,
        "ready_spread_s": 0.0,
        "platform": "?",
    }


class DeviceLedger:
    """Cumulative per-device dispatch accounting; one process-global
    instance (``LEDGER``). The lock only guards dict arithmetic."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._devices: dict[str, dict] = {}  # guarded-by: self._lock
        self._lanes: dict[str, dict] = {}  # guarded-by: self._lock
        # host-side totals across all devices  # guarded-by: self._lock
        self._totals: dict[str, float] = {
            "stage_s": 0.0,
            "launch_s": 0.0,
            "dispatches": 0.0,
        }

    # -- attribution -----------------------------------------------------

    def observe_sharded(self, out, *, launch_seconds: float = 0.0,
                        in_bytes: int = 0, out_bytes: int = 0) -> dict | None:
        """Attribute one sharded dispatch: wait on each position's ready
        event in turn, timing when each position's tile became ready.

        Per-position busy is the measured wait for that tile (it
        includes the H2D it was waiting on: end to end, the honest
        number); the ready spread (max−min) across positions is the
        imbalance signal, a lower bound since the waits are sequential.
        Transfer seconds are estimated from the byte split and the
        link-probe bandwidths. Returns the per-dispatch record, or None
        if ``out`` exposes no shards."""
        try:
            shards = list(out.addressable_shards)
        except AttributeError:
            return None
        if not shards:
            return None
        t0 = time.perf_counter()
        ready: list[tuple[str, str, float]] = []
        for sh in shards:
            sh.wait()
            ready.append((
                str(sh.position),
                sh.device.type,
                time.perf_counter() - t0,
            ))
        offsets = [r[2] for r in ready]
        spread = max(offsets) - min(offsets)
        n = len(ready)
        per_in = in_bytes // n
        per_out = out_bytes // n
        h2d_gbps, d2h_gbps = _transfer_estimates()
        h2d_est = per_in / (h2d_gbps * 1e9) if h2d_gbps else 0.0
        d2h_est = per_out / (d2h_gbps * 1e9) if d2h_gbps else 0.0
        per_launch = launch_seconds / n
        record = {
            "devices": {},
            "n_devices": n,
            "launch_s": launch_seconds,
            "ready_spread_s": spread,
            "wall_s": max(offsets),
        }
        with self._lock:
            self._totals["launch_s"] += launch_seconds
            self._totals["dispatches"] += 1
            for label, platform, off in ready:
                row = self._devices.setdefault(label, _device_row())
                row["platform"] = platform
                row["busy_s"] += off
                row["dispatches"] += 1
                row["launch_s"] += per_launch
                row["h2d_bytes"] += per_in
                row["d2h_bytes"] += per_out
                row["h2d_s_est"] += h2d_est
                row["d2h_s_est"] += d2h_est
                row["ready_spread_s"] += spread
                record["devices"][label] = round(off, 6)
        for label, _platform, off in ready:
            DEVICE_BUSY_SECONDS.inc(label, amount=off)
            DEVICE_DISPATCH_TOTAL.inc(label)
            DEVICE_LAUNCH_SECONDS.inc(label, amount=per_launch)
            if per_in:
                DEVICE_TRANSFER_BYTES.inc(label, "h2d", amount=per_in)
            if per_out:
                DEVICE_TRANSFER_BYTES.inc(label, "d2h", amount=per_out)
        return record

    def on_codec_dispatch(self, backend: str, in_bytes: int,
                          seconds: float) -> None:
        """ops/profiler.py bridge: a single-device codec dispatch
        (wall incl. sync) lands on the default device's row; host
        backends are not device work and are ignored here."""
        if backend not in _DEVICE_BACKENDS or seconds <= 0:
            return
        label = "0"
        h2d_gbps, _ = _transfer_estimates()
        h2d_est = in_bytes / (h2d_gbps * 1e9) if h2d_gbps else 0.0
        with self._lock:
            self._totals["dispatches"] += 1
            row = self._devices.setdefault(label, _device_row())
            row["busy_s"] += seconds
            row["dispatches"] += 1
            row["h2d_bytes"] += in_bytes
            row["h2d_s_est"] += h2d_est
        DEVICE_BUSY_SECONDS.inc(label, amount=seconds)
        DEVICE_DISPATCH_TOTAL.inc(label)
        if in_bytes:
            DEVICE_TRANSFER_BYTES.inc(label, "h2d", amount=in_bytes)

    def record_stage(self, seconds: float) -> None:
        """Serial host work a sharded dispatch paid before launch
        (padding copies, staging calls)."""
        if seconds <= 0:
            return
        with self._lock:
            self._totals["stage_s"] += seconds

    def record_lane(self, lane, seconds: float, n_bytes: int = 0) -> None:
        """One slab-ring reader (host staging lane) busy interval."""
        if seconds <= 0:
            return
        label = _lane_label(lane)
        with self._lock:
            row = self._lanes.setdefault(
                label, {"busy_s": 0.0, "chunks": 0, "bytes": 0}
            )
            row["busy_s"] += seconds
            row["chunks"] += 1
            row["bytes"] += n_bytes
        STAGING_LANE_SECONDS.inc(label, amount=seconds)

    # -- views -----------------------------------------------------------

    def baseline(self) -> dict:
        """Copy of the cumulative state, for round-scoped diffing."""
        with self._lock:
            return {
                "devices": {k: dict(v) for k, v in self._devices.items()},
                "lanes": {k: dict(v) for k, v in self._lanes.items()},
                "totals": dict(self._totals),
            }

    def snapshot(self, base: dict | None = None) -> dict:
        """The ledger's view: per-device rows
        (sorted by device id), staging lanes, host totals, and the
        busy-imbalance aggregate. With ``base`` (a :meth:`baseline`),
        every number is the delta since that snapshot."""
        cur = self.baseline()
        if base is not None:
            cur = _diff_state(cur, base)
        rows = []
        for label in sorted(cur["devices"], key=_label_key):
            row = dict(cur["devices"][label])
            row["device"] = label
            for k, v in row.items():
                if isinstance(v, float):
                    row[k] = round(v, 6)
            rows.append(row)
        lanes = []
        for label in sorted(cur["lanes"], key=_label_key):
            lr = dict(cur["lanes"][label])
            lr["lane"] = label
            lr["busy_s"] = round(lr["busy_s"], 6)
            lanes.append(lr)
        totals = {k: round(v, 6) for k, v in cur["totals"].items()}
        return {
            "devices": rows,
            "lanes": lanes,
            "totals": totals,
            "imbalance": _imbalance([r["busy_s"] for r in rows]),
        }

    def summary(self) -> dict | None:
        """Compact section for a telemetry snapshot; None while the
        ledger has seen no device work."""
        snap = self.snapshot()
        if not snap["devices"]:
            return None
        imb = snap["imbalance"]
        return {
            "devices": len(snap["devices"]),
            "dispatches": int(snap["totals"].get("dispatches", 0)),
            "busy_max_s": imb["max_s"],
            "busy_min_s": imb["min_s"],
            "busy_mean_s": imb["mean_s"],
            "imbalance_frac": imb["frac"],
            "lanes": len(snap["lanes"]),
        }

    def busy_seconds(self, label: str) -> float:
        with self._lock:
            row = self._devices.get(label)
            return row["busy_s"] if row else 0.0

    def lane_busy_seconds(self) -> float:
        with self._lock:
            return sum(r["busy_s"] for r in self._lanes.values())

    def imbalance_frac(self) -> float:
        with self._lock:
            busy = [r["busy_s"] for r in self._devices.values()]
        return _imbalance(busy)["frac"]

    def reset(self) -> None:
        with self._lock:
            self._devices.clear()
            self._lanes.clear()
            for k in self._totals:
                self._totals[k] = 0.0


def _label_key(label: str):
    try:
        return (0, int(label))
    except ValueError:
        return (1, label)


def _imbalance(busy: list[float]) -> dict:
    active = [b for b in busy if b > 0]
    if not active:
        return {"max_s": 0.0, "min_s": 0.0, "mean_s": 0.0,
                "spread_s": 0.0, "frac": 0.0}
    mx, mn = max(active), min(active)
    mean = sum(active) / len(active)
    return {
        "max_s": round(mx, 6),
        "min_s": round(mn, 6),
        "mean_s": round(mean, 6),
        "spread_s": round(mx - mn, 6),
        "frac": round((mx - mn) / mean, 4) if mean > 0 else 0.0,
    }


def _diff_state(cur: dict, base: dict) -> dict:
    out = {"devices": {}, "lanes": {}, "totals": {}}
    for section in ("devices", "lanes"):
        for label, row in cur[section].items():
            b = base[section].get(label, {})
            d = {}
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    d[k] = v - b.get(k, 0)
                else:
                    d[k] = v
            # a row idle for the whole window is noise, and would drag
            # the window's imbalance stats toward devices that only
            # worked before the baseline
            if not any(
                v for v in d.values() if isinstance(v, (int, float))
            ):
                continue
            out[section][label] = d
    for k, v in cur["totals"].items():
        out["totals"][k] = v - base["totals"].get(k, 0.0)
    return out


LEDGER = DeviceLedger()


# -- flight-recorder probes ------------------------------------------------


def install_probes(n_devices: int | None = None, recorder=None,
                   device=None) -> list:
    """Attach the ledger's probes to the flight recorder and return
    the ``(name, fn, kind)`` list the caller must hand back to
    :func:`remove_probes` — the same identity-matched contract the
    master's own probes use, so a bench-driven install/teardown can
    never strand (or tear down) another owner's probes.

    Per-position busy counters (``dev<N>_busy_s``, differenced by the
    recorder into busy-rate ≈ duty) are created for positions
    ``0..n_devices-1`` when given, else for the positions the ledger
    has already seen. ``device`` is the port's: ``None`` is the card
    and raises without one, ``"cpu"`` lets a CPU run watch the ledger."""
    from .. import resolve_device
    from .recorder import RECORDER

    resolve_device(device)
    rec = recorder if recorder is not None else RECORDER
    if n_devices is not None:
        labels = [str(i) for i in range(n_devices)]
    else:
        labels = [r["device"] for r in LEDGER.snapshot()["devices"]]
    probes: list[tuple] = []
    for label in labels:
        def busy(label=label) -> float:
            return LEDGER.busy_seconds(label)

        probes.append((f"dev{label}_busy_s", busy, "counter"))
    probes.append(
        ("device_imbalance", LEDGER.imbalance_frac, "gauge")
    )
    probes.append(
        ("staging_lanes_busy_s", LEDGER.lane_busy_seconds, "counter")
    )
    for name, fn, kind in probes:
        rec.register_probe(name, fn, kind)
    return probes


def remove_probes(probes: list, recorder=None) -> None:
    """Detach by identity: a newer owner's probe under the same name
    survives this (older) owner's teardown."""
    from .recorder import RECORDER

    rec = recorder if recorder is not None else RECORDER
    for name, fn, _kind in probes:
        rec.remove_probe(name, fn)


# -- scaling decomposition -------------------------------------------------


def scaling_efficiency(
    sec_per_step: dict, parallelism: int | None = None
) -> dict[int, float]:
    """``{n: t(1) / (min(n, P) * t(n))}`` for every measured device
    count — the same fixed-total-work slab encodes at every count, so
    perfect scaling is t(n) = t(1)/n and efficiency 1.0.

    ``parallelism`` P is the count of distinct compute units behind the
    positions. On a mesh of distinct cards P == n_devices,
    ``min(n, P) == n``, and this is the classic fixed-work efficiency.
    On a mesh whose positions share cards (``["cuda:0"] * 4``) or the
    CPU's cores (``["cpu"] * 8``) t(n) physically cannot drop below
    t(1)/P — dividing by n would grade the dispatch path against a
    speedup the hardware cannot express. ``min(n, P)`` is the
    achievable-speedup denominator; callers that want the raw number
    pass ``parallelism=None`` (the default, the reference's)."""
    sec = {}
    for k, v in (sec_per_step or {}).items():
        try:
            n = int(k)
        except (TypeError, ValueError):
            continue
        if isinstance(v, (int, float)) and v > 0:
            sec[n] = float(v)
    t1 = sec.get(1)
    if not t1:
        return {}
    cap = int(parallelism) if parallelism else None
    return {
        n: t1 / ((min(n, cap) if cap else n) * t)
        for n, t in sorted(sec.items()) if n > 1
    }


def decompose_scaling(sec_per_step: dict, components: dict,
                      n_devices: int,
                      parallelism: int | None = None) -> dict:
    """Amdahl-style decomposition of the scaling gap at ``n_devices``.

    The gap is ``t(N) - t(1)/N`` — the seconds per step the sweep paid
    beyond perfect scaling. ``components`` carries the measured
    per-step seconds at N for the four attributable costs:

    * ``serial_host``          — host staging/padding serial work
    * ``launch_serialization`` — dispatch-enqueue time on the host
    * ``transfer``             — estimated H2D+D2H seconds
    * ``imbalance``            — max−min per-device busy (ready spread)

    With ``parallelism`` P < N (positions sharing fewer cards or
    cores) a fifth component is attributed:

    * ``compute_serialization`` — ``t(1) * (1/min(N, P) - 1/N)``, the
      part of the gap that is time-slicing, not dispatch cost: N
      positions on P cards cannot beat t(1)/P no matter how clean the
      dispatch path is. On a mesh of distinct cards P == N and this
      term is exactly zero.

    Whatever the measurements don't cover — cross-device sync,
    collective overhead, and unattributed scheduler time — lands in
    the ``collective`` residual, clamped at zero. Fractions are of the
    total attributed gap (measured components + residual), so the
    named fractions sum to 1.0 by construction; ``gap_seconds`` and
    the raw per-component seconds ride along for absolute reading.

    ``efficiency`` is ceiling-aware when P is given (see
    :func:`scaling_efficiency`); the classic fixed-work number always
    rides along as ``efficiency_raw``."""
    eff = scaling_efficiency(sec_per_step, parallelism)
    eff_raw = scaling_efficiency(sec_per_step)
    sec = {int(k): float(v) for k, v in (sec_per_step or {}).items()
           if isinstance(v, (int, float)) and float(v) > 0}
    t1, tn = sec.get(1), sec.get(n_devices)
    names = ("serial_host", "launch_serialization", "transfer",
             "imbalance")
    comp = {
        name: max(0.0, float(components.get(name, 0.0) or 0.0))
        for name in names
    }
    cap = min(n_devices, int(parallelism)) if parallelism else n_devices
    comp["compute_serialization"] = (
        t1 * (1.0 / cap - 1.0 / n_devices) if t1 else 0.0
    )
    if t1 is None or tn is None:
        gap = 0.0
    else:
        gap = max(0.0, tn - t1 / n_devices)
    residual = max(0.0, gap - sum(comp.values()))
    total = sum(comp.values()) + residual
    if total <= 0:
        fractions = {name: 0.0 for name in comp}
        fractions["collective"] = 1.0
    else:
        fractions = {
            name: round(v / total, 4) for name, v in comp.items()
        }
        fractions["collective"] = round(residual / total, 4)
    return {
        "n_devices": n_devices,
        "parallelism": int(parallelism) if parallelism else n_devices,
        "gap_seconds": round(gap, 6),
        "ideal_seconds": round(t1 / n_devices, 6) if t1 else None,
        "efficiency": round(eff.get(n_devices, 0.0), 4),
        "efficiency_raw": round(eff_raw.get(n_devices, 0.0), 4),
        "seconds": {
            **{k: round(v, 6) for k, v in comp.items()},
            "collective": round(residual, 6),
        },
        "fractions": fractions,
    }
