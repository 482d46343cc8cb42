"""Sharded erasure-coding pipelines over a mesh of device positions.

The port's counterpart of ``seaweedfs_tpu/parallel/ec_sharded.py``, with
its structure and names. Three parallel axes:

* "vol"   — volume batch, the data-parallel axis (each position encodes
            its own volumes);
* "seq"   — shard byte columns, the sequence-parallel axis (GF encode is
            column-wise, so this needs no communication);
* "stripe"— bit-plane rows of the GF(2) product, contraction-parallel:
            partial parity bit-sums are added across positions, then
            reduced mod 2 (BASELINE config 4's parity aggregation).

One process drives every position, each with one CUDA stream of its own
(:func:`position_streams`): a position's staging copy, kernel and read
back run in order on its stream, and whatever another stream reads (the
stripe sum and the checksum's combine, both on one home position) waits
on the producer's event and is recorded on the reader's stream, so the
caching allocator never hands its memory out early. A ``cpu`` position
runs the plain versions where it is dispatched.

Dispatch discipline, as the reference's:

* **Per-position staging lanes** — :func:`stage_lanes` runs one lane a
  position; each copies only ITS shard view through a pinned host buffer
  on its stream and blocks on its own copy, so the staging wait is
  measured (``LEDGER.record_lane`` a lane + a synced ``record_stage``).
  Ragged batches zero-fill only the spill shards, per lane.
* **Dispatch cache** — :func:`compiled_dispatch` builds once per
  ``(kind, mesh, k, m[, axis])`` what a dispatch needs (the positions'
  streams and coefficients; the stripe kind's bit-matrix slices on their
  devices). ``trace_counts()`` counts builds per kind: a second call
  builds nothing.
* **Legacy mode** — ``SEAWEEDFS_SHARDED_LEGACY=1`` keeps the
  whole-array, rebuild-per-call dispatch callable, with the same bytes.

Every position's parity goes through ``gf_kernel.gf_matmul_fused`` (on a
card, the autotuned route's hand-written kernel; on the CPU, its plain
version). Outputs are :class:`ShardedArray`; ``np.asarray`` gathers one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bitmatrix, gf256, gf_matmul
from ..ops import link as link_mod
from ..ops.kernels import gf_kernel
from ..telemetry.devices import LEDGER
from .mesh import Mesh

_SPEC = ("vol", None, "seq")

# one host lane's dispatch-worth of staging, sized like encoder.py's
# _TARGET_CHUNK_SECONDS
_TARGET_LANE_SECONDS = 0.05
_MIN_LANE_CHUNK = 1 << 20
_MAX_LANE_CHUNK = 64 << 20

# the reference's checksum is a uint32 sum, which wraps
_U32_MASK = 0xFFFFFFFF


def _bitmat(k: int, m: int) -> np.ndarray:
    return bitmatrix.expand_bitmatrix(gf256.parity_matrix(k, m))


def legacy_dispatch_enabled() -> bool:
    """True when ``SEAWEEDFS_SHARDED_LEGACY`` selects the whole-array
    staging + build-per-call dispatch (never the production path)."""
    return os.environ.get("SEAWEEDFS_SHARDED_LEGACY", "") not in ("", "0")


# -- sharded results ---------------------------------------------------------


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """Make ``device`` and its position's ``stream`` current in this
    thread (CUDA); nothing for a ``cpu`` position."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _ready(stream):
    """An event recorded on ``stream`` now (None for a ``cpu``
    position, whose work is done when it returns)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


class Shard:
    """One position's tile of a :class:`ShardedArray`: its ``index``
    (a tuple of slices) into the global shape, the ``data`` tensor on
    ``device``, the position's ``stream`` and the ``event`` that marks
    ``data`` ready."""

    __slots__ = ("position", "device", "index", "data", "stream", "event")

    def __init__(self, position, device, index, data, stream, event):
        self.position = position
        self.device = device
        self.index = index
        self.data = data
        self.stream = stream
        self.event = event

    def wait(self) -> None:
        """Block the host until ``data`` is ready."""
        if self.event is not None:
            self.event.synchronize()


class ShardedArray:
    """A global array of ``shape`` whose tiles lie on mesh positions;
    the counterpart of the reference's sharded ``jax.Array``. Read it
    whole with :meth:`numpy` or ``np.asarray``; ``addressable_shards``
    lists the tiles in position order (the ledger's seam)."""

    def __init__(self, shape, shards: list[Shard], dtype=np.uint8):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self.addressable_shards = shards

    def numpy(self) -> np.ndarray:
        """Gather the tiles into one host array. Byte tiles on a card are
        read back into pinned host memory, every tile's copy enqueued on
        its position's stream before any is waited on; a tile whose place
        in the array is not one contiguous run lands in a pinned buffer
        of its own first."""
        shards = self.addressable_shards
        on_card = any(sh.stream is not None for sh in shards)
        if not on_card or self.dtype != np.uint8:
            out = np.empty(self.shape, dtype=self.dtype)
            for sh in shards:
                with _on(sh.device, sh.stream):
                    out[sh.index] = sh.data.cpu().numpy()
            return out
        out = torch.empty(self.shape, dtype=torch.uint8, pin_memory=True)
        pending = []
        for sh in shards:
            dst = out[sh.index]
            with _on(sh.device, sh.stream):
                if dst.is_contiguous():
                    dst.copy_(sh.data, non_blocking=True)
                    buf = None
                else:
                    buf = torch.empty(sh.data.shape, dtype=torch.uint8,
                                      pin_memory=True)
                    buf.copy_(sh.data, non_blocking=True)
                pending.append((dst, buf, _ready(sh.stream)))
        for dst, buf, ev in pending:
            if ev is not None:
                ev.synchronize()
            if buf is not None:
                dst.copy_(buf)
        return out.numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)


def _lanes(mesh: Mesh, spec, shape) -> list[tuple[int, torch.device, tuple]]:
    """(position, device, index) of every position for ``shape`` split
    per ``spec`` (an axis name or None a dimension). A split dimension
    must divide evenly, as the reference's ``NamedSharding`` requires:
    ragged data goes through ``pad_to``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, name in zip(shape, spec):
        if name is None:
            continue
        if name not in mesh.shape:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {name!r}")
        if dim % mesh.shape[name]:
            raise ValueError(f"{shape} does not split {mesh.shape[name]} "
                             f"ways along {name!r}")
    lanes = []
    for p, coord in enumerate(np.ndindex(*mesh.devices.shape)):
        idx = []
        for dim, name in zip(shape, spec):
            if name is None:
                idx.append(slice(0, dim))
                continue
            a = mesh.axis_names.index(name)
            step = dim // mesh.devices.shape[a]
            idx.append(slice(coord[a] * step, (coord[a] + 1) * step))
        lanes.append((p, mesh.devices[coord], tuple(idx)))
    return lanes


# -- dispatch cache -----------------------------------------------------------

_CACHE_LOCK = threading.Lock()
# (kind, mesh, k, m[, axis]) -> _Dispatch
_COMPILED: dict[tuple, "_Dispatch"] = {}  # guarded-by: _CACHE_LOCK
_CACHE_STATS = {"hits": 0, "misses": 0}  # guarded-by: _CACHE_LOCK
# kind -> builds of a dispatch entry (a cache hit builds nothing)
_TRACE_COUNTS: dict[str, int] = {}  # guarded-by: _CACHE_LOCK
# positions (as strings, in order) -> one CUDA stream a position
_STREAMS: dict[tuple, list] = {}  # guarded-by: _CACHE_LOCK


def _note_trace(kind: str) -> None:
    with _CACHE_LOCK:
        _TRACE_COUNTS[kind] = _TRACE_COUNTS.get(kind, 0) + 1


def cache_stats() -> dict[str, int]:
    with _CACHE_LOCK:
        return dict(_CACHE_STATS)


def trace_counts() -> dict[str, int]:
    with _CACHE_LOCK:
        return dict(_TRACE_COUNTS)


def reset_dispatch_cache() -> None:
    """Drop every cached dispatch entry and position stream (tests; a
    mesh teardown would otherwise pin dead device buffers)."""
    with _CACHE_LOCK:
        _COMPILED.clear()
        _STREAMS.clear()
        _CACHE_STATS["hits"] = 0
        _CACHE_STATS["misses"] = 0
        _TRACE_COUNTS.clear()


def position_streams(mesh: Mesh) -> list:
    """One CUDA stream for each position of ``mesh`` (None for a ``cpu``
    position), made once per sequence of positions: a mesh re-shaped
    over the same positions keeps their streams."""
    key = tuple(str(d) for d in mesh.devices.flat)
    with _CACHE_LOCK:
        streams = _STREAMS.get(key)
    if streams is not None:
        return streams
    made = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in mesh.devices.flat]
    with _CACHE_LOCK:
        return _STREAMS.setdefault(key, made)


class _Dispatch:
    """What one cache key's dispatches need: the positions' streams, the
    parity matrix (its bytes ride in each kernel launch's arguments),
    and for the stripe kind each position's slice of the zero-padded
    bit-matrix on its device."""

    def __init__(self, kind: str, mesh: Mesh, k: int, m: int,
                 axis: str | None):
        if kind not in ("encode_all", "parity", "step", "stripe"):
            raise ValueError(f"unknown dispatch kind: {kind}")
        self.kind, self.mesh, self.k, self.m = kind, mesh, k, m
        self.streams = position_streams(mesh)
        self.matrix = gf256.parity_matrix(k, m)
        if kind != "stripe":
            return
        if axis not in mesh.shape:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
        n_dev = mesh.shape[axis]
        self.pad = (-(k * 8)) % n_dev
        self.width = (k * 8 + self.pad) // n_dev
        bm = _bitmat(k, m).astype(np.float32)
        if self.pad:
            bm = np.pad(bm, ((0, 0), (0, self.pad)))
        # the positions along ``axis`` at index 0 of every other axis: a
        # replica along another axis would compute the same partial
        order = np.arange(mesh.size).reshape(mesh.devices.shape)
        line = np.moveaxis(order, mesh.axis_names.index(axis), 0)
        self.line = [int(p) for p in line.reshape(n_dev, -1)[:, 0]]
        self.bm = []
        for i, p in enumerate(self.line):
            dev = mesh.devices.flat[p]
            cols = bm[:, i * self.width:(i + 1) * self.width]
            with _on(dev, self.streams[p]):
                self.bm.append(torch.from_numpy(
                    np.ascontiguousarray(cols)).to(dev))

    def __call__(self, staged: ShardedArray):
        """Enqueue every position's tile on its stream (a ``cpu``
        position computes here); returns the sharded output, and for the
        ``step`` kind the checksum beside it."""
        V, k, N = staged.shape
        m = self.m
        rows = {"encode_all": k + m, "parity": m, "step": k + m}[self.kind]
        shards, sums = [], []
        for sh in staged.addressable_shards:
            stream = self.streams[sh.position]
            with _on(sh.device, stream):
                parity = gf_kernel.gf_matmul_fused(self.matrix, sh.data)
                out = (parity if self.kind == "parity"
                       else torch.cat([sh.data, parity], dim=-2))
                if self.kind == "step":
                    sums.append(out.sum(dim=-1, dtype=torch.int64))
                ev = _ready(stream)
            vol, _, seq = sh.index
            shards.append(Shard(sh.position, sh.device,
                                (vol, slice(0, rows), seq), out, stream, ev))
        out = ShardedArray((V, rows, N), shards)
        if self.kind != "step":
            return out
        return out, self._checksum(out, sums)

    def _checksum(self, out: ShardedArray, sums: list[torch.Tensor]):
        """[V, k+m] per-(volume, shard) sums over the sequence axis,
        combined across the "seq" positions of each "vol" row on the
        row's first position, uint32 as the reference's."""
        rows: dict[tuple, list[int]] = {}
        for i, sh in enumerate(out.addressable_shards):
            rows.setdefault((sh.index[0].start, sh.index[0].stop),
                            []).append(i)
        shards = []
        for (lo, hi), members in rows.items():
            home = out.addressable_shards[members[0]]
            with _on(home.device, home.stream):
                parts = [_to_home(sums[i], out.addressable_shards[i], home)
                         for i in members]
                total = combine_checksum(parts)
                ev = _ready(home.stream)
            shards.append(Shard(home.position, home.device,
                                (slice(lo, hi), slice(0, out.shape[1])),
                                total, home.stream, ev))
        return ShardedArray(out.shape[:2], shards, dtype=np.uint32)

    def stripe(self, data) -> ShardedArray:
        """data[k, N] → parity[m, N] on the line's first position."""
        k, m, s = self.k, self.m, self.width
        host = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
        if host.ndim != 2 or host.shape[0] != k:
            raise ValueError(f"data must be [{k}, N], got {host.shape}")
        n = host.shape[1]
        partials = []
        for i, p in enumerate(self.line):
            dev, stream = self.mesh.devices.flat[p], self.streams[p]
            lo, hi = i * s, (i + 1) * s
            r0, r1 = min(lo // 8, k), min(-(-hi // 8), k)
            with _on(dev, stream):
                rows = torch.from_numpy(host[r0:r1]).to(dev)
                bits = gf_matmul.unpack_bits(rows)[lo - r0 * 8:hi - r0 * 8]
                if bits.shape[0] < s:  # the zero-padded contraction rows
                    bits = F.pad(bits, (0, 0, 0, s - bits.shape[0]))
                part = torch.matmul(self.bm[i], bits.to(torch.float32))
                partials.append(Shard(p, dev, None, part, stream,
                                      _ready(stream)))
        # the "psum": every partial copied to the first position and
        # added there, then the mod-2 reduction and the byte pack
        home = partials[0]
        with _on(home.device, home.stream):
            acc = None
            for sh in partials:
                x = _to_home(sh.data, sh, home)
                acc = x if acc is None else acc + x
            parity = gf_matmul.pack_bits(acc.to(torch.int32) & 1)
            ev = _ready(home.stream)
        return ShardedArray((m, n), [Shard(
            home.position, home.device, (slice(0, m), slice(0, n)), parity,
            home.stream, ev)])


def _to_home(t: torch.Tensor, src: Shard, home: Shard) -> torch.Tensor:
    """``t``, made on ``src``'s stream, for use on ``home``'s stream
    (which must be current). On one card the home stream waits for
    ``src``'s work and the allocator learns that it uses ``t``; across
    cards (or to the host) the copy runs on ``src``'s stream, and the
    copy itself orders the home stream after it."""
    if src.stream is None:
        return t.to(home.device)
    if src.device == home.device:
        home.stream.wait_event(_ready(src.stream))
        t.record_stream(home.stream)
        return t
    with _on(src.device, src.stream):
        return t.to(home.device)


def combine_checksum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum of int64 partial checksums, wrapped mod 2^32 as the
    reference's uint32 sum is."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total & _U32_MASK


def compiled_dispatch(
    kind: str, mesh: Mesh, k: int, m: int, axis: str | None = None
) -> _Dispatch:
    """The cached dispatch entry for ``(kind, mesh, k, m)``, built once
    per geometry.

    ``Mesh`` hashes by value, so every reconstruction of the same mesh
    hits the same entry. A racing first call may build twice; the
    loser's entry is discarded and only one is ever cached."""
    key = (kind, mesh, k, m) if axis is None else (kind, mesh, k, m, axis)
    with _CACHE_LOCK:
        hit = _COMPILED.get(key)
        if hit is not None:
            _CACHE_STATS["hits"] += 1
            return hit
    built = _build(kind, mesh, k, m, axis)
    with _CACHE_LOCK:
        won = _COMPILED.setdefault(key, built)
        if won is built:
            _CACHE_STATS["misses"] += 1
        else:
            _CACHE_STATS["hits"] += 1
        return won


def _build(kind: str, mesh: Mesh, k: int, m: int, axis: str | None):
    """One cache key's entry. Runs OUTSIDE the cache lock: the
    coefficient uploads must never serialise other dispatchers."""
    _note_trace(kind)
    return _Dispatch(kind, mesh, k, m, axis)


# -- per-position staging lanes -----------------------------------------------


def choose_lane_plan(n_lanes: int, lane_bytes: int) -> tuple[int, int]:
    """(lane_workers, chunk_bytes) for per-position host staging, sized
    from the ``ops/link.py`` EWMAs choose_pipeline-style.

    Staging is host-side copy work: more concurrent lanes than host
    CPUs only contend, so the worker depth is ``min(n_lanes, CPUs)``.
    ``chunk_bytes`` is one lane's dispatch-worth of bytes — the probed
    H2D rate split across the active workers and sized to
    ``_TARGET_LANE_SECONDS`` per put, clamped to [1 MiB, 64 MiB] powers
    of two. With no probe on record the default (4 MiB) stands."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # platforms without affinity masks
        cpus = os.cpu_count() or 1
    workers = max(1, min(n_lanes, cpus))
    res = link_mod.STATE.probe_result or {}
    rate = res.get("h2d_gbps") or link_mod.estimates().get("host") or 0
    if rate:
        target = int(rate * 1e9 * _TARGET_LANE_SECONDS / workers)
        chunk = 1 << max(1, target).bit_length() - 1
        chunk = min(_MAX_LANE_CHUNK, max(_MIN_LANE_CHUNK, chunk))
    else:
        chunk = 4 << 20
    if lane_bytes:
        while chunk > _MIN_LANE_CHUNK and chunk // 2 >= lane_bytes:
            chunk //= 2
    return workers, chunk


def _shard_view(data: np.ndarray, idx: tuple, shape: tuple):
    """One position's shard of the LOGICAL (possibly padded) ``shape``,
    materialised from the real ``data`` extent: a zero-copy view when
    the shard lies fully inside the data, else a zero-filled per-shard
    buffer with the real overlap copied in — so ragged batches never
    pay a whole-array padded host copy, only their spill shards do."""
    spans = [sl.indices(dim) for sl, dim in zip(idx, shape)]
    shard_shape = tuple(stop - start for start, stop, _ in spans)
    clipped = tuple(
        slice(start, min(stop, real))
        for (start, stop, _), real in zip(spans, data.shape)
    )
    view = data[clipped]
    if view.shape == shard_shape:
        return view
    buf = np.zeros(shard_shape, dtype=data.dtype)
    buf[tuple(slice(0, s) for s in view.shape)] = view
    return buf


def _put(view: np.ndarray, device: torch.device, stream):
    """(tile, ready event): ``view`` copied to ``device``, a host copy
    for a ``cpu`` position; else through a pinned buffer, async on the
    position's stream, the caller's thread blocked until the copy
    landed."""
    if stream is None:
        return torch.from_numpy(np.array(view)), None
    with _on(device, stream):
        pinned = torch.empty(view.shape, dtype=torch.uint8, pin_memory=True)
        pinned.numpy()[...] = view
        tile = pinned.to(device, non_blocking=True)
        ev = _ready(stream)
    ev.synchronize()
    return tile, ev


def stage_lanes(
    data: np.ndarray,
    mesh: Mesh,
    pad_to: tuple[int, ...] | None = None,
    spec=_SPEC,
    ledger=LEDGER,
) -> ShardedArray:
    """Per-position host staging: one lane a position.

    Each lane copies exactly its position's shard view of ``data`` and
    BLOCKS on its own copy, so the staging wait is measured — per lane
    in ``ledger.record_lane`` (label ``d<position>``) and in total via a
    synced ``record_stage``. Lanes run on up to :func:`choose_lane_plan`
    workers; a worker names its position's device and stream.

    ``pad_to`` gives the LOGICAL shape when ``data`` is a ragged batch:
    shards spilling past the real extent zero-fill per lane instead of
    forcing a whole padded host copy. Returns the staged tiles as a
    :class:`ShardedArray` split per ``spec``."""
    data = np.asarray(data, dtype=np.uint8)
    shape = tuple(pad_to) if pad_to is not None else data.shape
    lanes = _lanes(mesh, spec, shape)
    streams = position_streams(mesh)
    workers, _chunk = choose_lane_plan(
        len(lanes),
        int(np.prod(shape[1:], dtype=np.int64)) if shape else 0,
    )
    t_all = time.perf_counter()

    def put(lane) -> Shard:
        p, dev, idx = lane
        t0 = time.perf_counter()
        view = _shard_view(data, idx, shape)
        tile, ev = _put(view, dev, streams[p])
        ledger.record_lane(
            f"d{p}", time.perf_counter() - t0, int(view.nbytes)
        )
        return Shard(p, dev, idx, tile, streams[p], ev)

    if workers > 1 and len(lanes) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            shards = list(pool.map(put, lanes))
    else:
        shards = [put(lane) for lane in lanes]
    # every lane blocked on its own copy above, so this span is synced
    ledger.record_stage(time.perf_counter() - t_all)
    return ShardedArray(shape, shards)


# -- sharded encode entry points ---------------------------------------------


def encode_sharded(
    data, mesh: Mesh, data_shards: int = 10, parity_shards: int = 4
) -> ShardedArray:
    """Volume+sequence-parallel encode: data[V, k, N] split over
    ("vol", None, "seq") → shards[V, k+m, N] split the same way.

    No communication: each position encodes its (volume, column) tile.
    Staging goes through the per-position lanes and the dispatch through
    the cache; ``SEAWEEDFS_SHARDED_LEGACY=1`` routes to the whole-array
    path instead."""
    if legacy_dispatch_enabled():
        return _encode_sharded_legacy(
            data, mesh, data_shards, parity_shards
        )
    in_bytes = int(getattr(data, "nbytes", 0))
    staged = stage_lanes(data, mesh)
    fn = compiled_dispatch("encode_all", mesh, data_shards, parity_shards)
    t0 = time.perf_counter()
    # launch-only on purpose: the enqueue cost of the cached entry is the
    # ledger's launch-serialization column; the compute wait is paid and
    # attributed per position in observe_sharded right below
    out = fn(staged)
    launch_s = time.perf_counter() - t0
    LEDGER.observe_sharded(
        out, launch_seconds=launch_s, in_bytes=in_bytes,
        out_bytes=in_bytes * (data_shards + parity_shards) // data_shards,
    )
    return out


def _encode_sharded_legacy(
    data, mesh: Mesh, data_shards: int, parity_shards: int
) -> ShardedArray:
    """The whole-array dispatch kept callable for measurement: ONE host
    call stages the whole array (one whole host copy, then each
    position's tile in turn), and the dispatch entry is built anew per
    call, uncached and uncounted; never the production path."""
    in_bytes = int(getattr(data, "nbytes", 0))
    t0 = time.perf_counter()
    whole = np.array(data, dtype=np.uint8)
    streams = position_streams(mesh)
    shards = []
    for p, dev, idx in _lanes(mesh, _SPEC, whole.shape):
        tile, ev = _put(whole[idx], dev, streams[p])
        shards.append(Shard(p, dev, idx, tile, streams[p], ev))
    staged = ShardedArray(whole.shape, shards)
    fn = _Dispatch("encode_all", mesh, data_shards, parity_shards, None)
    LEDGER.record_stage(time.perf_counter() - t0)
    t0 = time.perf_counter()
    # launch-only on purpose: enqueue + rebuild cost is the ledger's
    # launch-serialization column; compute is timed per position below
    out = fn(staged)
    launch_s = time.perf_counter() - t0
    LEDGER.observe_sharded(
        out, launch_seconds=launch_s, in_bytes=in_bytes,
        out_bytes=in_bytes * (data_shards + parity_shards) // data_shards,
    )
    return out


def encode_stripe_psum(
    data, mesh: Mesh, data_shards: int = 10, parity_shards: int = 4,
    axis: str = "stripe",
) -> ShardedArray:
    """Contraction-parallel encode with explicit parity aggregation.

    The GF(2) bit product contracts over k*8 bit rows; those rows are
    split across the ``axis`` positions, each computes a partial integer
    bit-sum (one float32 matrix product, exact: every sum ≤ k*8), and
    the partials are copied to the first position and added there before
    the mod-2 reduction.

    data[k, N] (host) → parity[m, N] on the first position. Ragged splits
    — (k*8) not divisible by the position count — zero-pad the
    contraction axis: zero bit rows (and matching zero matrix columns)
    add nothing, so every position gets an equal slice."""
    fn = compiled_dispatch(
        "stripe", mesh, data_shards, parity_shards, axis=axis
    )
    return fn.stripe(data)


def encode_batch_parity(
    data: np.ndarray,
    mesh: Mesh,
    data_shards: int = 10,
    parity_shards: int = 4,
    defer: bool = False,
):
    """Production multi-device encode for the ``ec.encode`` data path.

    data[V, k, N] uint8 (host) → parity[V, m, N] uint8 (host), with V
    split over the mesh "vol" axis and N over "seq". Ragged V/N pad up
    to mesh divisibility ONLY in the spill shards (per staging lane) and
    slice back — GF encode is column-wise, so padding columns/volumes
    never changes real output. With ``defer=True`` it returns the
    materialiser, which does the D2H (and the ledger's per-position
    waits) when the caller's writer thread calls it."""
    V, k, N = data.shape
    if k != data_shards:
        raise ValueError(f"data has {k} shards, not {data_shards}")
    a = mesh.shape["vol"]
    if V % a:
        # ragged volume group (commonly a singleton): fold every
        # position into "seq" — work per position is the same, and it
        # pads at most b-1 COLUMNS instead of a-1 volumes
        mesh = Mesh(mesh.devices.reshape(1, -1), ("vol", "seq"))
        a = 1
    b = mesh.shape["seq"]
    vp = -(-V // a) * a
    np_ = -(-N // b) * b
    staged = stage_lanes(data, mesh, pad_to=(vp, k, np_))
    fn = compiled_dispatch("parity", mesh, data_shards, parity_shards)
    # parity only: the data shards already live on the host
    t0 = time.perf_counter()
    # launch-only on purpose: the enqueue cost of the cached entry is the
    # launch-serialization column; the compute wait is timed per position
    # at materialise
    parity = fn(staged)
    launch_s = time.perf_counter() - t0
    in_bytes = int(data.nbytes)
    out_bytes = in_bytes * parity_shards // data_shards

    def materialize() -> np.ndarray:
        """D2H + unpad; with ``defer=True`` the caller pays this on its
        writer thread so the fetch overlaps the next slab's compute."""
        LEDGER.observe_sharded(
            parity, launch_seconds=launch_s, in_bytes=in_bytes,
            out_bytes=out_bytes,
        )
        return np.asarray(parity)[:V, :, :N]

    return materialize if defer else materialize()


def sharded_ec_step(
    data, mesh: Mesh, data_shards: int = 10, parity_shards: int = 4
):
    """Encode a sharded volume batch and reduce a global integrity
    checksum across the mesh.

    Returns (shards[V, k+m, N] sharded, checksum[V, k+m] uint32). The
    checksum sums over the sequence axis ACROSS positions: each position
    sums its columns in int64, the "seq" positions' partials are added
    on each row's first position, and the total wraps mod 2^32 as the
    reference's uint32 sum does."""
    in_bytes = int(getattr(data, "nbytes", 0))
    staged = stage_lanes(data, mesh)
    fn = compiled_dispatch("step", mesh, data_shards, parity_shards)
    shards, checksum = fn(staged)
    LEDGER.observe_sharded(
        shards, in_bytes=in_bytes,
        out_bytes=in_bytes * (data_shards + parity_shards) // data_shards,
    )
    return shards, checksum
