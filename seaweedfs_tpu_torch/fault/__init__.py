"""Runtime fault injection: named points with deterministic seeds.

The port's copy of ``seaweedfs_tpu/fault``. A fault *point* is a named
site in the serving path:

    http.client.send        every outbound client request (util/http.py)
    volume.replicate.send   one replica write in the fan-out
    ec.shard.read           one remote EC shard fetch
    codec.dispatch          one GF codec dispatch (ops/codec.py), before
                            any work, on every route (kernel, native
                            host codec, plain version)

An armed ``FaultSpec`` decides, per traversal, whether to inject an
``error`` (raises ``FaultInjected``), a ``conn_drop`` / ``partition``
(raises too; partition matches a peer substring), or ``latency`` (stalls
the caller). Decisions are driven by a per-spec seeded RNG plus a fire
count, so a chaos run replays EXACTLY.

Every injected fault is tagged on the active tracing span
(``fault.point``/``fault.kind`` attrs) and counted in
``seaweedfs_fault_injected_total{point,kind}``.

Control surfaces: ``SEAWEEDFS_FAULTS`` env (JSON list of specs, read at
import), ``REGISTRY.inject(point, kind, count=..., ...)`` /
``REGISTRY.clear()`` in process, and ``/admin/fault`` on every server
(``install_routes`` — 403 unless ``SEAWEEDFS_FAULTS_ADMIN=1`` opts in,
see ``admin_enabled``).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass

from ..stats import metrics as stats

# leaf tracing module only — util/http.py imports this package back,
# so the tracing package init must stay out of this import chain
from ..tracing import span as trace_span

KINDS = ("error", "latency", "conn_drop", "partition")

FAULT_INJECTED = stats.REGISTRY.counter(
    "seaweedfs_fault_injected_total",
    "Counter of injected faults by point and kind.",
    ("point", "kind"),
)


class FaultInjected(Exception):
    """Raised at a fault point when an armed spec fires.

    A site either translates it into its own failure shape or lets it
    propagate (the codec seam does: ``write_ec_files`` raises it).
    ``status`` only matters for kind="error".
    """

    def __init__(self, point: str, kind: str, status: int = 503):
        self.point = point
        self.kind = kind
        self.status = status
        super().__init__(f"injected {kind} at {point}")


@dataclass
class FaultSpec:
    """One armed fault: where, what, how often, for how many fires."""

    point: str
    kind: str = "error"
    probability: float = 1.0
    count: int | None = None  # max fires; None = until cleared
    delay: float = 0.0        # latency kind: seconds to stall
    status: int = 503         # error kind: status to surface
    peer: str = ""            # substring match against site context
    seed: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (want one of {KINDS})"
            )
        # per-spec RNG: a fixed seed makes probabilistic chaos replay
        self._rng = random.Random(self.seed)

    def matches(self, ctx: dict) -> bool:
        if not self.peer:
            return True
        return any(self.peer in str(v) for v in ctx.values())

    def to_dict(self) -> dict:
        return {
            "point": self.point,
            "kind": self.kind,
            "probability": self.probability,
            "count": self.count,
            "delay": self.delay,
            "status": self.status,
            "peer": self.peer,
            "seed": self.seed,
            "fired": self.fired,
        }


class FaultRegistry:
    """Process-wide armed-fault table.

    One registry per process: the in-proc cluster harness shares it
    across every server, which is exactly what the chaos suite wants
    (specs target a server via ``peer`` matching when needed).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # point name -> armed specs  # guarded-by: self._lock
        self._specs: dict[str, list[FaultSpec]] = {}

    def inject(self, point: str, kind: str = "error", **kw) -> FaultSpec:
        spec = FaultSpec(point=point, kind=kind, **kw)
        with self._lock:
            self._specs.setdefault(point, []).append(spec)
        return spec

    def clear(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._specs = {}
            else:
                self._specs.pop(point, None)

    def list(self) -> list[dict]:
        with self._lock:
            return [
                s.to_dict()
                for specs in self._specs.values()
                for s in specs
            ]

    def load(self, specs: list[dict]) -> None:
        for d in specs:
            self.inject(**d)

    def pick(self, point: str, ctx: dict) -> FaultSpec | None:
        """The spec that fires for this traversal, or None."""
        with self._lock:
            for spec in self._specs.get(point, []):
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                if not spec.matches(ctx):
                    continue
                if (
                    spec.probability < 1.0
                    and spec._rng.random() >= spec.probability
                ):
                    continue
                spec.fired += 1
                return spec
        return None

    @property
    def armed(self) -> bool:
        # lock-free emptiness peek: the hot path (every outbound
        # request) must cost one dict bool when no fault is armed
        return bool(self._specs)


REGISTRY = FaultRegistry()


def point(name: str, **ctx) -> None:
    """Declare a named fault site; a no-op unless a matching spec is
    armed. ``ctx`` values (url/peer/op/...) feed spec ``peer``
    matching. Raises FaultInjected for error/conn_drop/partition;
    latency stalls and returns."""
    if not REGISTRY.armed:
        return
    spec = REGISTRY.pick(name, ctx)
    if spec is None:
        return
    FAULT_INJECTED.inc(name, spec.kind)
    sp = trace_span.current()
    if sp is not None:
        sp.attrs["fault.point"] = name
        sp.attrs["fault.kind"] = spec.kind
    if spec.kind == "latency":
        time.sleep(spec.delay)
        return
    raise FaultInjected(name, spec.kind, status=spec.status)


def _configure_from_env() -> None:
    raw = os.environ.get("SEAWEEDFS_FAULTS", "")
    if not raw:
        return
    try:
        REGISTRY.load(json.loads(raw))
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad SEAWEEDFS_FAULTS: {e}") from None


_configure_from_env()


# -- /admin/fault (installed on every server's router) -----------------------


def admin_enabled() -> bool:
    """Whether the /admin/fault control surface accepts requests.

    The endpoint can inject errors, stalls, and partitions into every
    server — a DoS switchboard — so it ships disabled and must be
    armed explicitly with SEAWEEDFS_FAULTS_ADMIN=1 (a chaos test bed
    sets it for its process).
    Checked per request so a harness can arm it after servers start.
    """
    return os.environ.get("SEAWEEDFS_FAULTS_ADMIN", "").lower() in (
        "1", "true", "yes"
    )


def _deny_admin():
    from ..util.http import Response

    return Response.error(
        "fault admin disabled (set SEAWEEDFS_FAULTS_ADMIN=1)", 403
    )


def _h_fault_get(req):
    from ..util.http import Response

    if not admin_enabled():
        return _deny_admin()
    return Response.json(
        {"faults": REGISTRY.list()}
    )


def _h_fault_post(req):
    from ..util.http import Response

    if not admin_enabled():
        return _deny_admin()
    body = req.json()
    action = body.pop("action", "inject")
    if action == "clear":
        REGISTRY.clear(body.get("point"))
        return Response.json({"ok": True, "faults": REGISTRY.list()})
    if action != "inject":
        return Response.error(f"unknown action {action!r}", 400)
    try:
        spec = REGISTRY.inject(**body)
    except (TypeError, ValueError) as e:
        return Response.error(str(e), 400)
    return Response.json({"ok": True, "injected": spec.to_dict()})


def install_routes(router) -> None:
    """Expose GET/POST /admin/fault on a server's router (prepended so
    catch-all data-plane patterns — the S3 gateway's — don't shadow
    it, same convention as /debug/traces). The handlers refuse with
    403 unless admin_enabled() — arming faults over the network is
    strictly opt-in."""
    router.add("GET", r"/admin/fault", _h_fault_get, prepend=True)
    router.add("POST", r"/admin/fault", _h_fault_post, prepend=True)


def _configure_from_env() -> None:
    raw = os.environ.get("SEAWEEDFS_FAULTS", "")
    if not raw:
        return
    try:
        REGISTRY.load(json.loads(raw))
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad SEAWEEDFS_FAULTS: {e}") from None


_configure_from_env()
