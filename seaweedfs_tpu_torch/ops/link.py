"""Link-aware codec routing: the card's path must never lose to the host.

The port's counterpart of ``seaweedfs_tpu/ops/link.py``. Above the size
floor (``ops/codec.DEVICE_MIN_BYTES``), a ``cuda`` codec's dispatch may
run on the card or on the native host codec; this module decides which:

* a one-time lazy **probe** measures H2D and D2H bandwidth of the
  codec's card with CUDA events and the round-trip latency of a small
  copy with the host clock, and seeds the card path's estimate;
* every real dispatch feeds a rolling **EWMA** of achieved end-to-end
  GB/s per path (device vs host), so the estimate tracks the machine;
* :func:`choose` projects both paths' wall time for the next dispatch
  and routes to whichever is faster. While the host is winning, every
  32nd dispatch is still routed to the card (``reason="probe"``) so a
  recovered link is rediscovered without a dedicated probe transfer.

Unlike the reference, a probe that fails raises: the reference routes to
the host (``"noprobe"``) when it finds no device, but a ``cuda`` codec
has a card by construction, so a failing probe is a fault to surface,
not a reason to hide the card.

Decisions are counted in ``seaweedfs_codec_route_total{path,reason}`` and
the live estimates shown in ``seaweedfs_codec_link_gbps{path}``, both in
the port's registry (``stats.REGISTRY``). The state is process-global
(:data:`STATE`), as in the reference.
"""

from __future__ import annotations

import threading
import time

from ..stats.metrics import REGISTRY

ROUTE_TOTAL = REGISTRY.counter(
    "seaweedfs_codec_route_total",
    "GF codec routing decisions by chosen path and reason",
    labels=("path", "reason"),
)
LINK_GBPS = REGISTRY.gauge(
    "seaweedfs_codec_link_gbps",
    "EWMA effective codec throughput by path (device incl. transfers)",
    labels=("path",),
)

# EWMA smoothing: ~0.3 weight on the newest sample tracks a changing link
# within a few dispatches without flapping on one outlier.
_ALPHA = 0.3
# While the host is winning, send every Nth eligible dispatch to the
# device anyway so a recovered link is noticed (the dispatch is real
# work, so the worst case is one slow slab per window).
_REPROBE_EVERY = 32
# Device compute prior for the probe's round-trip projection (GB/s), the
# reference's; the card's kernel alone runs far faster (PERF.md §6), so
# the seeded estimate is conservative.
_DEVICE_COMPUTE_GBPS_PRIOR = 50.0
# Host codec prior until the first native dispatch is observed (GB/s).
_HOST_GBPS_PRIOR = 0.5
# Bytes of the probe's timed copies.
_PROBE_BYTES = 1 << 20


class LinkState:
    """Rolling estimates + probe results; one process-global instance."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gbps: dict[str, float] = {}  # guarded-by: self._lock
        self._since_device = 0  # guarded-by: self._lock
        self.probe_result: dict[str, float] | None = None

    # -- observations ----------------------------------------------------

    def observe(self, route: str, n_bytes: int, seconds: float) -> None:
        if seconds <= 0 or n_bytes <= 0:
            return
        gbps = n_bytes / seconds / 1e9
        with self._lock:
            prev = self._gbps.get(route)
            cur = gbps if prev is None else (
                _ALPHA * gbps + (1 - _ALPHA) * prev
            )
            self._gbps[route] = cur
        LINK_GBPS.set(cur, route)

    def estimate(self, route: str) -> float | None:
        with self._lock:
            return self._gbps.get(route)

    # -- probe -----------------------------------------------------------

    def probe(self, device=None, force: bool = False) -> dict[str, float]:
        """Measure H2D/D2H bandwidth + round-trip latency of ``device``
        (a CUDA device; None: the current one); seeds the device-path
        estimate. Lazy, one-shot; raises when the measurement fails."""
        with self._lock:
            if self.probe_result is not None and not force:
                return self.probe_result
        res = _measure_link(device)
        with self._lock:
            self.probe_result = res
            # Seed the device estimate from the probe: project a 1 MiB
            # dispatch's round trip (H2D + compute + D2H at parity ratio).
            if "h2d_gbps" in res and "device" not in self._gbps:
                nb = 1 << 20
                t = (
                    nb / max(res["h2d_gbps"], 1e-6) / 1e9
                    + nb / _DEVICE_COMPUTE_GBPS_PRIOR / 1e9
                    + 0.4 * nb / max(res["d2h_gbps"], 1e-6) / 1e9
                    + res.get("rtt_s", 0.0)
                )
                self._gbps["device"] = nb / t / 1e9
                LINK_GBPS.set(self._gbps["device"], "device")
        return res

    # -- decision --------------------------------------------------------

    def choose(self, in_bytes: int, device=None) -> tuple[bool, str]:
        """(use_device, reason) for a dispatch of ``in_bytes`` input on
        ``device``; probes that device first if nothing has been probed.

        Projects wall time per path: the device pays its EWMA throughput
        (end-to-end incl. transfers) PLUS the probed fixed round-trip
        latency, so small-but-above-floor dispatches on a high-latency
        link route to the host even when the device's streaming rate
        wins — the projection is genuinely size-sensitive.
        """
        if self.probe_result is None:
            self.probe(device)
        dev = self.estimate("device")
        host = self.estimate("host") or _HOST_GBPS_PRIOR
        if dev is None:
            return True, "default"
        rtt = (self.probe_result or {}).get("rtt_s", 0.0)
        t_dev = in_bytes / (dev * 1e9) + rtt
        t_host = in_bytes / (host * 1e9)
        if t_dev <= t_host:
            with self._lock:
                self._since_device = 0
            return True, "link"
        with self._lock:
            self._since_device += 1
            if self._since_device >= _REPROBE_EVERY:
                self._since_device = 0
                return True, "probe"
        return False, "link"


def _measure_link(device=None) -> dict[str, float]:
    """H2D/D2H bandwidth of ``_PROBE_BYTES`` between pinned host memory
    and ``device``, each copy timed with CUDA events on a stream of that
    device (device time of the copy alone), and the round-trip latency:
    the host-clock time of a 64-byte H2D copy and its synchronize."""
    import torch

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the link probe measures a CUDA device, not {dev}")
    nb = _PROBE_BYTES
    host = torch.arange(nb, dtype=torch.int32).to(torch.uint8).pin_memory()
    back = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        on_card = torch.empty(nb, dtype=torch.uint8, device=dev)
        # warm the copy path AT FULL PROBE SIZE first — a cold first
        # copy (allocator, DMA setup) would otherwise be charged to the
        # H2D window and crater the seeded device estimate
        on_card.copy_(host, non_blocking=True)
        back.copy_(on_card, non_blocking=True)
        stream.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record(stream)
        on_card.copy_(host, non_blocking=True)
        marks[1].record(stream)
        back.copy_(on_card, non_blocking=True)
        marks[2].record(stream)
        marks[2].synchronize()
        t_h2d = marks[0].elapsed_time(marks[1]) / 1e3
        t_d2h = marks[1].elapsed_time(marks[2]) / 1e3
        t0 = time.perf_counter()
        on_card[:64].copy_(host[:64], non_blocking=True)
        stream.synchronize()
        rtt = time.perf_counter() - t0
    if not torch.equal(back, host):
        raise RuntimeError(f"link probe: {dev} returned other bytes")
    # event times cover the copies alone, so unlike the reference's
    # host-clock windows no round trip is subtracted from them
    h2d = nb / max(t_h2d, 1e-9) / 1e9
    d2h = nb / max(t_d2h, 1e-9) / 1e9
    res = {
        "h2d_gbps": h2d,
        "d2h_gbps": d2h,
        "rtt_s": rtt,
        "probe_bytes": float(nb),
    }
    LINK_GBPS.set(h2d, "h2d")
    LINK_GBPS.set(d2h, "d2h")
    return res


STATE = LinkState()


def observe(route: str, n_bytes: int, seconds: float) -> None:
    STATE.observe(route, n_bytes, seconds)


def choose(in_bytes: int, device=None) -> tuple[bool, str]:
    return STATE.choose(in_bytes, device)


def probe(device=None, force: bool = False) -> dict[str, float]:
    return STATE.probe(device, force)


def snapshot() -> dict[str, float | None]:
    """Current link picture for diagnostics."""
    res = dict(STATE.probe_result or {})
    res["device_gbps_ewma"] = STATE.estimate("device")
    res["host_gbps_ewma"] = STATE.estimate("host")
    return res


def estimates() -> dict[str, float | None]:
    """Side-effect-free view of the routing EWMAs for pipeline sizing.

    Unlike :func:`probe`/:func:`choose`, this NEVER touches the device
    — the EC encoder consults it to size its slab ring (batch bytes /
    pipeline depth) before any dispatch has happened. All values may be
    None before the first dispatch.
    """
    return {
        "device": STATE.estimate("device"),
        "host": STATE.estimate("host"),
        "rtt_s": (STATE.probe_result or {}).get("rtt_s"),
    }
