"""Per-device dispatch ledger.

The port's counterpart of ``seaweedfs_tpu/telemetry/devices.py``, with
its single-device seams and views. It answers where the card's time
went, per device, before anyone claims a scaling win:

* **codec dispatches** arrive through the ``ops/profiler.py`` bridge
  (:meth:`DeviceLedger.on_codec_dispatch`): the ``cuda`` backend's
  dispatches attribute wall-incl-sync seconds (staging, H2D, kernel and
  the D2H wait) and input bytes to the default device's row, ``"0"``;
  the native host codec and the plain version (``cpu``) are not device
  work and are ignored;
* **host staging lanes** are fed by the slab readers of
  ``storage/erasure_coding/encoder.py`` (one lane per volume reader).

H2D seconds are *estimates* from the byte counts and the
``ops/link.py`` probe bandwidth. Everything is exposed as bounded-label
metrics of the port's registry (``seaweedfs_device_busy_seconds{device}``
and four more families; lane labels are clamped) and as
:meth:`DeviceLedger.snapshot` / :meth:`DeviceLedger.summary`.

The sharded seam (``observe_sharded``) and the scaling decomposition
come with the port's multi-GPU compute plane.
"""

from __future__ import annotations

import threading

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
        """Serial host work a dispatch paid before launch (padding
        copies, staging calls)."""
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
