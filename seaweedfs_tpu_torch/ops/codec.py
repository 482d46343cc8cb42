"""Reed-Solomon codec over GF(2^8)/0x11d: the seam every higher layer
(EC encoder, rebuild, EC reads) calls.

Counterpart of ``seaweedfs_tpu/ops/codec.py`` with the same methods and
the same ``PendingResult`` contract. Each dispatch takes one of three
routes, chosen as the reference's ``_choose_backend`` chooses
(``seaweedfs_tpu/ops/codec.py:58-78``; :func:`choose_backend`):

* ``cuda`` — the Hopper kernel (``ops/kernels/gf_swar.py``). Host slabs
  go H2D from pinned memory on the codec's own stream, the result comes
  back D2H into pinned memory, and ``PendingResult.result()`` waits on
  an event recorded after that copy — so ``encode_async`` may run on one
  thread and ``result()`` on another, as the encoder pipeline does.
* ``native`` — the host codec (``native/gf256.cc``), on the calling
  thread for ``encode`` and ``reconstruct`` and on a small host pool for
  ``encode_async``. A ``cuda`` codec's dispatch takes it when its shards
  are narrower than the floor (``device_min_bytes``, default
  :data:`DEVICE_MIN_BYTES`; reason ``"size"``), or when the link-aware
  router (``ops/link.py``) projects the host faster for this size from
  the measured throughput of both paths (reason ``"link"``).
* ``cpu`` — the kernel's plain PyTorch version at every size, for tests
  on a machine without a card (reason ``"platform"``). Only an explicit
  ``device="cpu"`` selects it; link routing never runs for it.

Above the floor, a ``cuda`` codec asks ``link.choose`` (reasons
``"link"`` and ``"probe"``; the first call probes the card) unless it was
made with ``link_aware=False``, which sends every such dispatch to the
kernel (reason ``"static"``). Every dispatch runs the ``codec.dispatch``
fault point first, then its work inside the profiler's annotation; a
dispatch that raises counts ``seaweedfs_codec_route_total{path,"error"}``,
one that succeeds is recorded once (``ops/profiler.py``, the route
counter, and, unless its reason is ``"size"`` or ``"platform"``, the
route's throughput estimate).
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import fault, native, resolve_device, tracing
from . import gf256, link, profiler
from .kernels import gf_swar
from .kernels.build import LaunchCounter

# Below this many bytes a shard, a ``cuda`` codec's dispatch stays on the
# host: the crossover where the kernel's round trip (H2D, launch, D2H)
# overtakes the native codec for a one-output reconstruction from ten
# survivors, a power of two. chip_smoke.py phase 10 measures it and
# prints it beside this value: on an NVIDIA H100 80GB HBM3 at 700 W the
# native codec was faster up to 64 KiB a shard, the two about even at
# 128 KiB, and the kernel faster from 256 KiB on (PERF.md §5). The
# reference keeps 64 KiB, the TPU's.
DEVICE_MIN_BYTES = 256 * 1024

# Dispatches that took the native host route, beside gf_swar.LAUNCHES.
HOST_DISPATCHES = LaunchCounter()

# Host dispatches compute synchronously; encode_async runs them here so
# the encoder pipeline overlaps them with disk I/O the way it overlaps a
# kernel's. Threads start at the first host dispatch.
_host_pool = ThreadPoolExecutor(max_workers=2)


# Reasons whose dispatches feed no throughput estimate: under the floor
# a dispatch is dominated by fixed per-call overhead and would crater the
# host estimate that steers multi-MiB slab routing, and the plain version
# is not a path a ``cuda`` codec can take.
_UNROUTABLE = ("size", "platform")


def choose_route(backend: str, shard_bytes: int,
                 device_min_bytes: int) -> str:
    """The size step of the routing: where one dispatch of
    ``shard_bytes`` a shard runs on a codec of ``backend`` before the
    link is asked: ``"cpu"`` (the plain version, at every size),
    ``"native"`` (the host codec, under the floor) or ``"cuda"``."""
    if backend == "cpu":
        return "cpu"
    if shard_bytes < device_min_bytes:
        return "native"
    return "cuda"


def choose_backend(backend: str, shard_bytes: int, in_bytes: int,
                   device_min_bytes: int, link_aware: bool = True,
                   device=None) -> tuple[str, str]:
    """(route, reason) for one dispatch of ``in_bytes`` input,
    ``shard_bytes`` a shard, on a codec of ``backend`` and ``device``:
    the size floor first (:func:`choose_route`), then, for a ``cuda``
    codec above it, ``link.choose`` unless ``link_aware`` is off."""
    route = choose_route(backend, shard_bytes, device_min_bytes)
    if route == "cpu":
        return "cpu", "platform"
    if route == "native":
        return "native", "size"
    if not link_aware:
        return "cuda", "static"
    use_device, reason = link.choose(in_bytes, device)
    return ("cuda" if use_device else "native"), reason


def _path(route: str) -> str:
    return "device" if route == "cuda" else "host"


def _record(route: str, reason: str, o: int, k: int, n_bytes: int,
            seconds: float, parent) -> None:
    """One successful dispatch: the profiler (histogram, device ledger,
    span under ``parent``), the route counter, and the route's
    throughput estimate."""
    profiler.record(route, o, k, n_bytes, seconds, parent=parent)
    link.ROUTE_TOTAL.inc(_path(route), reason)
    if reason not in _UNROUTABLE:
        link.observe(_path(route), n_bytes, seconds)


def _native_matmul(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """coeff[o, k] ∘GF data[..., k, n] on the native host codec."""
    if data.ndim == 2:
        return native.gf_matmul(coeff, data)
    *lead, k, n = data.shape
    slabs = data.reshape(-1, k, n)
    return np.stack(
        [native.gf_matmul(coeff, d) for d in slabs]
    ).reshape(*lead, coeff.shape[0], n)


def _native_recorded(matrix: np.ndarray, data: np.ndarray,
                     record) -> np.ndarray:
    """A pooled native dispatch: its in-worker compute time is what is
    recorded, whenever the caller collects the result."""
    t0 = time.perf_counter()
    out = _native_matmul(matrix, data)
    record(time.perf_counter() - t0)
    return out


class PendingResult:
    """Handle for an in-flight codec dispatch; ``result()`` materialises
    the host array (for ``cuda``: waits for the D2H copy), memoised, on
    whichever thread calls it.

    A kernel dispatch is recorded here, once: ``launch_seconds`` (its
    staging, H2D and launch on the dispatching thread) plus the wait
    inside the first ``result()`` — NOT the time the handle sat in a
    queue behind disk writes, which would bias routing against the card.
    A failed ``result()`` records nothing."""

    def __init__(self, backend: str, getter, record=None,
                 launch_seconds: float = 0.0):
        self._backend = backend
        self._getter = getter
        self._record = record
        self._launch_seconds = launch_seconds
        self._out: np.ndarray | None = None

    @property
    def backend(self) -> str:
        return self._backend

    def result(self) -> np.ndarray:
        if self._out is None:
            t0 = time.perf_counter()
            out = self._getter()
            if self._record is not None:
                self._record(
                    self._launch_seconds + time.perf_counter() - t0
                )
            self._out = out
            # drop the staging buffers the getter holds
            self._getter = self._record = None
        return self._out


def _ceil_quantum(n: int) -> int:
    return -(-n // gf_swar.QUANTUM) * gf_swar.QUANTUM


def _materialise(done: torch.cuda.Event, host_out: torch.Tensor,
                 source: torch.Tensor, lead: tuple[int, ...],
                 n: int) -> np.ndarray:
    """Wait for a dispatch's D2H and return its [..., o, n] host view.
    ``source`` is the pinned H2D input, held until now so no one
    refills it while the copy may still read it."""
    done.synchronize()
    del source
    _, o, width = host_out.shape
    return host_out.numpy().reshape(*lead, o, width)[..., :n]


def _stacked(rows: list[np.ndarray]) -> np.ndarray:
    """The 1-D ``rows`` as one [k, n] array: a view, with no copy, when
    they are the consecutive rows of one C-contiguous array (a rebuild
    window read into a ``host_zeros`` buffer, which then goes H2D as it
    is); else a stacked copy."""
    first = rows[0]
    n = first.shape[0]
    base = first.base
    if base is not None and all(
        r.base is base and r.flags["C_CONTIGUOUS"]
        and r.ctypes.data == first.ctypes.data + i * n
        for i, r in enumerate(rows)
    ):
        return np.lib.stride_tricks.as_strided(first, (len(rows), n), (n, 1))
    return np.stack(rows)


@functools.lru_cache(maxsize=2048)
def _reconstruction(
    k: int, m: int, present: tuple[int, ...], wanted: tuple[int, ...] | None
) -> tuple[gf_swar.SwarCoeff | None, tuple[int, ...]]:
    """(kernel coefficients, missing ids) for one loss pattern; cached,
    since a rebuild reuses one pattern for every window."""
    r, missing = gf256.reconstruction_matrix(k, m, present)
    if wanted is not None:
        keep = set(wanted)
        rows = [i for i, sid in enumerate(missing) if sid in keep]
        r, missing = r[rows], [missing[i] for i in rows]
    if not missing:
        return None, ()
    return gf_swar.coeff_from_reference(r), tuple(missing)


class RSCodec:
    """Reed-Solomon (k data, m parity) codec over GF(2^8)/0x11d.

    Shards are byte arrays of equal length N. Shard ids 0..k-1 are data,
    k..k+m-1 parity — the ``.ec00–.ec13`` numbering. ``device`` is
    ``None`` (the card; raises without one), ``"cuda[:i]"`` or
    ``"cpu"``. ``device_min_bytes`` is the floor under which a ``cuda``
    codec's dispatch takes the native host route (0: every dispatch
    takes the kernel); it is the counterpart of the reference's
    ``SEAWEEDFS_TPU_CODEC`` override, for pinning a route.
    ``link_aware=False`` is the reference's ``SEAWEEDFS_TPU_LINK_AWARE=0``:
    above the floor every dispatch takes the kernel, reason
    ``"static"``, instead of the route ``ops/link.py`` projects faster.
    Limits: m <= 16 parity and k <= 64 data shards (the kernel's)."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 device: str | torch.device | None = None,
                 device_min_bytes: int = DEVICE_MIN_BYTES,
                 link_aware: bool = True):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("GF(256) supports at most 256 total shards")
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        if device_min_bytes < 0:
            raise ValueError("device_min_bytes must be >= 0")
        self.device_min_bytes = device_min_bytes
        self.link_aware = link_aware
        self._parity = gf_swar.coeff_from_reference(
            gf256.parity_matrix(data_shards, parity_shards)
        )
        self._stream = (
            torch.cuda.Stream(self.device) if self.backend == "cuda" else None
        )
        self._lock = threading.Lock()
        self._staged_bytes = 0  # guarded-by: self._lock

    @property
    def staged_bytes(self) -> int:
        """Host bytes ``cuda`` dispatches copied into pinned staging
        buffers so far: 0 while every slab arrives pinned, contiguous
        and 16-byte wide (``host_zeros``)."""
        with self._lock:
            return self._staged_bytes

    def _count_staged(self, n_bytes: int) -> None:
        with self._lock:
            self._staged_bytes += n_bytes

    # -- host buffers ----------------------------------------------------

    def host_zeros(self, shape: tuple[int, ...]) -> np.ndarray:
        """A zeroed uint8 host buffer for data headed to this codec.
        On ``cuda`` it is pinned, so a dispatch straight from it (C
        contiguous, rows a multiple of 16 bytes) needs no staging copy
        and its H2D copy runs as async DMA. The array keeps its memory
        alive."""
        if self.backend == "cuda":
            return torch.zeros(
                shape, dtype=torch.uint8, pin_memory=True
            ).numpy()
        return np.zeros(shape, dtype=np.uint8)

    # -- dispatch --------------------------------------------------------

    def _stage(self, data: np.ndarray, batch: int, width: int):
        """Pinned [batch, k, width] tensor holding ``data`` zero-padded
        to ``width``: the caller's own buffer when it already is one,
        else a copy (strided slab views, ragged widths, pageable
        memory — an H2D from pageable memory would not overlap)."""
        k, n = data.shape[-2:]
        if n == width and data.flags["C_CONTIGUOUS"]:
            t = torch.from_numpy(data)
            if t.is_pinned():
                return t.view(batch, k, width)
        staged = torch.empty(
            (batch, k, width), dtype=torch.uint8, pin_memory=True
        )
        view = staged.numpy()
        view[..., :n] = data.reshape(batch, k, n)
        view[..., n:] = 0
        self._count_staged(staged.numel())
        return staged

    def _launch(self, coeff: gf_swar.SwarCoeff, host_in: torch.Tensor,
                lead: tuple[int, ...], n: int):
        """H2D of the pinned ``host_in`` [B, k, W], kernel, D2H into a
        fresh pinned output, all on the codec's stream; returns the
        getter that waits on the event recorded after the D2H."""
        o = coeff.shape[0]
        batch, k, width = host_in.shape
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev_in = torch.empty(
                (batch, k, width), dtype=torch.uint8, device=self.device
            )
            dev_in.copy_(host_in, non_blocking=True)
            dev_out = torch.empty(
                (batch, o, width), dtype=torch.uint8, device=self.device
            )
            gf_swar.launch(coeff, dev_in, dev_out, self._stream)
            host_out = torch.empty(
                (batch, o, width), dtype=torch.uint8, pin_memory=True
            )
            host_out.copy_(dev_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the getter holds the H2D source until it has returned
        return functools.partial(
            _materialise, done, host_out, host_in, lead, n
        )

    def _dispatch_async(self, coeff: gf_swar.SwarCoeff, data: np.ndarray,
                        inline: bool = False) -> PendingResult:
        """Start ``coeff ∘GF data`` on the route :func:`choose_backend`
        gives, in the reference's order: the ``codec.dispatch`` fault
        point before any work, the work inside the profiler's
        annotation, an ``"error"`` route count if it raises. The native
        route runs on the host pool and records in the worker, or on the
        calling thread when ``inline`` (a caller about to wait for the
        result, as the reference's synchronous ``_dispatch`` does); the
        kernel route records at ``result()``; the others at once. The
        launching thread's tracing span parents every record."""
        if data.dtype != np.uint8 or data.ndim < 2:
            raise ValueError(
                f"data must be uint8 [..., k, N], got {data.dtype} "
                f"{data.shape}"
            )
        *lead, _, n = data.shape
        route, reason = choose_backend(
            self.backend, n, data.size, self.device_min_bytes,
            self.link_aware, self.device,
        )
        # chaos seam: lets a test fail one codec dispatch and watch the
        # EC pipeline surface it cleanly
        fault.point("codec.dispatch", backend=route, n_bytes=data.size)
        # the launching request's span, captured here: both the host
        # pool worker and a later result() on the writer thread lack it
        parent = tracing.current()
        o, k = coeff.shape
        record = functools.partial(_record, route, reason, o, k, data.size,
                                   parent=parent)
        t0 = time.perf_counter()
        try:
            with profiler.annotation(f"codec.encode({route},{o}x{k})"):
                if route == "cpu":
                    out = gf_swar.gf_matmul_plain(
                        coeff, torch.from_numpy(np.ascontiguousarray(data))
                    ).numpy()
                elif route == "native":
                    HOST_DISPATCHES.add()
                    if not inline:
                        job = _host_pool.submit(
                            _native_recorded, coeff.matrix, data, record
                        )
                        return PendingResult("native", job.result)
                    out = _native_matmul(coeff.matrix, data)
                else:
                    batch = int(np.prod(lead)) if lead else 1
                    host_in = self._stage(data, batch, _ceil_quantum(n))
                    getter = self._launch(coeff, host_in, tuple(lead), n)
                    # launch-only time here: result() adds its wait
                    return PendingResult("cuda", getter, record,
                                         time.perf_counter() - t0)
        except BaseException:
            link.ROUTE_TOTAL.inc(_path(route), "error")
            raise
        record(time.perf_counter() - t0)
        return PendingResult(route, lambda: out)

    # -- encode ----------------------------------------------------------

    def _check_data(self, data) -> np.ndarray:
        data = np.asarray(data)
        if data.ndim < 2 or data.shape[-2] != self.data_shards:
            raise ValueError(
                f"expected [..., {self.data_shards}, N] data, got "
                f"{data.shape}"
            )
        return data.astype(np.uint8, copy=False)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data[..., k, N] uint8 → parity[..., m, N] uint8."""
        return self._dispatch_async(
            self._parity, self._check_data(data), inline=True
        ).result()

    def encode_async(self, data: np.ndarray) -> PendingResult:
        """Launch the parity computation without waiting; ``.result()``
        on the returned handle yields parity[..., m, N]. The encoder
        pipeline uses this to overlap slab N's write-back with slab
        N+1's compute. ``data`` may be reused once ``result()`` has
        returned."""
        return self._dispatch_async(self._parity, self._check_data(data))

    def encode_shards(self, data: np.ndarray) -> np.ndarray:
        """data[..., k, N] → all shards [..., k+m, N] (data then parity)."""
        data = self._check_data(data)
        return np.concatenate([data, self.encode(data)], axis=-2)

    # -- verify ----------------------------------------------------------

    def verify(self, shards: np.ndarray) -> bool:
        """shards[..., k+m, N] → do the parity rows match the data rows?"""
        shards = np.asarray(shards, np.uint8)
        parity = self.encode(shards[..., : self.data_shards, :])
        return bool(
            np.array_equal(parity, shards[..., self.data_shards:, :])
        )

    # -- reconstruct -----------------------------------------------------

    def reconstruct(
        self,
        shards: dict[int, np.ndarray],
        wanted: list[int] | None = None,
    ) -> dict[int, np.ndarray]:
        """Present {shard_id: bytes[N]} → rebuilt {missing_id: bytes[N]}.

        Uses the first k present shards in ascending id order (the
        reference's Reconstruct selection, so rebuilt bytes are
        identical). ``wanted`` restricts which missing ids are computed.
        """
        present = tuple(sorted(shards))
        coeff, missing = _reconstruction(
            self.data_shards, self.parity_shards, present,
            None if wanted is None else tuple(sorted(set(wanted))),
        )
        if not missing:
            return {}
        use = present[: self.data_shards]
        rows = [np.asarray(shards[i], np.uint8) for i in use]
        n = rows[0].shape[-1]
        if any(r.shape != (n,) for r in rows):
            raise ValueError("present shards must be equal-length 1-D rows")
        rebuilt = self._dispatch_async(
            coeff, _stacked(rows), inline=True
        ).result()
        return {sid: rebuilt[i] for i, sid in enumerate(missing)}

    def reconstruct_data(
        self, shards: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        """Like reconstruct, but only rebuilds missing *data* shards —
        the ``ReconstructData`` fast path of EC reads."""
        wanted = [i for i in range(self.data_shards) if i not in shards]
        return self.reconstruct(shards, wanted=wanted)
