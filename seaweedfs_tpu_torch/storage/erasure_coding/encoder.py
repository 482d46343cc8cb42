""".dat → .ec00…ec13 streaming encoder on the port's codec.

The port's counterpart of ``seaweedfs_tpu/storage/erasure_coding/
encoder.py`` (SeaweedFS weed/storage/erasure_coding/ec_encoder.go:56-231):
row-major striping per ``layout.encode_row_plan``, zero padding past
EOF, and ``.ecx`` = the needle-id-sorted, folded copy of the ``.idx``.

Slabs [k, batch] stream through a 3-stage pipeline:

  reader thread:  disk read of slab N+2        (one-deep prefetch)
  main thread:    async codec dispatch of N+1  (H2D + kernel enqueue)
  writer thread:  result() of slab N (D2H wait) + 14 shard-file writes

Disk reads land via ``readinto`` directly in a ring of preallocated slab
buffers (:class:`_SlabRing`). On a ``cuda`` codec the ring is pinned
host memory, so a full-width slab goes H2D with no staging copy. A slab
returns to the ring only after the writer finished its chunk (the
in-flight fence), so it is never refilled while the codec or the writer
may still read it.

``write_ec_files_batch`` encodes many volumes at once on one card: the
volumes of one ``.dat`` size share a chunk plan, and each chunk of all of
them goes to the codec as one lane-packed [k, V·n] slab.

``batch_bytes`` and the pipeline depth size themselves from the
``ops/link.py`` routing EWMAs (:func:`choose_pipeline`) unless the
caller pins them, and every volume reader records its busy time as a
host staging lane of the device ledger (``telemetry/devices.py``).

Left for a later slice: the mesh branch of ``write_ec_files_batch``
(multi-GPU).
"""

from __future__ import annotations

import contextlib
import os
import queue
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...ops import codec as codec_mod
from ...ops import link as link_mod
from ...telemetry.devices import LEDGER as _DEVICE_LEDGER
from .. import idx as idx_mod
from . import constants as C
from .layout import encode_row_plan

# Per-shard slab bytes per codec call when the link EWMAs have no
# opinion yet. 8 MiB × 10 shards = 80 MiB input.
DEFAULT_BATCH_BYTES = 8 * 1024 * 1024

# Max slabs in flight (read-but-unwritten); bounds host memory.
PIPELINE_DEPTH = 3

# Shard output files carry a sized write buffer so row views coalesce
# into few large kernel writes; the per-file buffer shrinks so the sum
# across one encode's files stays under _MAX_WRITE_BUFFER_TOTAL.
WRITE_BUFFER_BYTES = 8 << 20
_MAX_WRITE_BUFFER_TOTAL = 128 << 20

# Adaptive sizing bounds (choose_pipeline): one codec dispatch should
# take ~_TARGET_CHUNK_SECONDS at the link's measured throughput — long
# enough to amortise dispatch, short enough that the 3 stages interleave
# at a fine grain.
_TARGET_CHUNK_SECONDS = 0.05
_MIN_BATCH_BYTES = 1 << 20
_MAX_BATCH_BYTES = 64 << 20
# Total ring memory cap: depth is shrunk before slabs are.
_MAX_RING_BYTES = 512 << 20


def _write_buffering(n_files: int, row_bytes: int) -> int:
    """Per-file write-buffer bytes for an encode opening ``n_files``
    shard outputs with typical ``row_bytes``-sized appends."""
    per_file = min(
        WRITE_BUFFER_BYTES,
        max(1 << 20, _MAX_WRITE_BUFFER_TOTAL // max(1, n_files)),
    )
    return max(per_file, min(row_bytes * 2, WRITE_BUFFER_BYTES))


def choose_pipeline(
    dat_size: int,
    k: int = C.DATA_SHARDS,
    batch_bytes: int | None = None,
    volumes: int = 1,
    devices: int = 1,
) -> tuple[int, int]:
    """(batch_bytes, pipeline_depth) for one encode run of ``volumes``
    volumes of ``dat_size`` bytes encoded in lockstep.

    A caller-pinned ``batch_bytes`` is honoured verbatim with the
    default depth. Otherwise the slab is sized from the ``ops/link.py``
    EWMAs (``link.estimates()``, which never probes) so one [k, batch]
    dispatch takes about ``_TARGET_CHUNK_SECONDS`` on the faster path —
    clamped to [1 MiB, 64 MiB] powers of two — or is the default slab
    while no estimate exists; then halved while half of it still covers
    a shard's share of the volume. Depth deepens by one when the device
    estimate runs more than 4× the host's (reads are then the
    bottleneck and deserve more prefetch), and shrinks, not below 2,
    before ring memory (volumes × k × batch × (depth + 1)) would pass
    ``_MAX_RING_BYTES``. ``devices`` scales the dispatch target for a
    slab split over that many cards."""
    if batch_bytes is not None:
        return batch_bytes, PIPELINE_DEPTH
    if volumes < 1 or devices < 1:
        raise ValueError(f"volumes {volumes} and devices {devices} must be "
                         "positive")
    est = link_mod.estimates()
    rates = [v for v in (est["device"], est["host"]) if v]
    batch = DEFAULT_BATCH_BYTES
    if rates:
        target = (
            max(rates) * 1e9 * _TARGET_CHUNK_SECONDS * devices / max(1, k)
        )
        batch = 1 << (max(1, int(target)).bit_length() - 1)
        batch = min(_MAX_BATCH_BYTES, max(_MIN_BATCH_BYTES, batch))
    per_shard = -(-dat_size // max(1, k))
    while batch > _MIN_BATCH_BYTES and batch // 2 >= per_shard:
        batch //= 2
    depth = PIPELINE_DEPTH
    if est["device"] and est["host"] and est["device"] > 4 * est["host"]:
        depth += 1
    while depth > 2 and (depth + 1) * k * batch * volumes > _MAX_RING_BYTES:
        depth -= 1
    return batch, depth


class _SlabRing:
    """Ring of preallocated, zeroed slab buffers with an explicit
    in-flight fence.

    ``acquire()`` blocks until a slab is free; ``release()`` returns
    one. The pipeline releases a slab only after the writer finished
    the chunk that used it. ``alloc(shape)`` makes each slab and must
    return it zeroed (``RSCodec.host_zeros``: pinned on ``cuda``), so a
    first use may skip EOF zero-fill (``take_pristine``)."""

    def __init__(self, depth: int, shape: tuple[int, ...], alloc=None):
        alloc = alloc or (lambda s: np.zeros(s, dtype=np.uint8))
        self._free: queue.Queue[np.ndarray] = queue.Queue()
        self._pristine: set[int] = set()
        for _ in range(depth):
            slab = alloc(shape)
            self._pristine.add(id(slab))
            self._free.put(slab)

    def acquire(self) -> np.ndarray:
        return self._free.get()

    def take_pristine(self, slab: np.ndarray) -> bool:
        """True exactly once per slab, on its first use while still all
        zeros — the caller may skip zero-filling padding."""
        try:
            self._pristine.remove(id(slab))
            return True
        except KeyError:
            return False

    def release(self, slab: np.ndarray) -> None:
        self._free.put(slab)


@contextlib.contextmanager
def launcher_for(encoder):
    """Context manager yielding the async ``launch`` callable for an
    encoder: an ``RSCodec`` (its ``encode_async``), an object with a
    sync ``.encode``, or a plain sync callable. Sync encoders run on a
    worker thread owned here, shut down on every exit path."""
    launch = getattr(encoder, "encode_async", None)
    if launch is not None:
        yield launch
        return
    fn = encoder.encode if hasattr(encoder, "encode") else encoder
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        yield lambda data: pool.submit(fn, data)
    finally:
        pool.shutdown(wait=True)


def _run_pipeline(
    n_chunks: int, read_fn, launch, write_fn, pt=None,
    release_fn=None, depth: int = PIPELINE_DEPTH,
):
    """Drive the 3-stage overlap: for each chunk index, read
    (prefetched), launch the encode asynchronously (``launch(data)`` →
    handle with ``.result()``), and hand (data, pending parity) to the
    single writer thread, which calls ``pending.result()`` so the D2H
    wait overlaps the next slab's dispatch. Exceptions from any stage
    propagate.

    ``release_fn(ci, data)`` runs after chunk ``ci``'s shard writes
    complete (success or failure): the slab-reuse fence.

    ``pt`` (telemetry/phases.PhaseTimer or None): ``h2d`` = the async
    launch on the dispatching thread (staging + H2D + enqueue),
    ``codec`` = the writer-side ``pending.result()`` wait (kernel + D2H),
    ``write`` = the shard-file writes; ``read``/``stage`` are recorded
    inside ``_read_row_chunk``."""

    def write_one(ci, data, pending):
        try:
            if pt is None:
                write_fn(ci, data, pending.result())
                return
            t0 = time.perf_counter()
            parity = pending.result()
            pt.add("codec", time.perf_counter() - t0, int(data.nbytes))
            t0 = time.perf_counter()
            write_fn(ci, data, parity)
            pt.add(
                "write",
                time.perf_counter() - t0,
                int(data.nbytes) + int(getattr(parity, "nbytes", 0)),
            )
        finally:
            if release_fn is not None:
                release_fn(ci, data)

    with ThreadPoolExecutor(max_workers=1) as reader, \
            ThreadPoolExecutor(max_workers=1) as writer:
        nxt = None
        writes: deque = deque()
        loop_ok = False
        try:
            for ci in range(n_chunks):
                data = nxt.result() if nxt is not None else read_fn(ci)
                nxt = (
                    reader.submit(read_fn, ci + 1)
                    if ci + 1 < n_chunks
                    else None
                )
                t0 = time.perf_counter()
                pending = launch(data)
                if pt is not None:
                    pt.add("h2d", time.perf_counter() - t0, int(data.nbytes))
                writes.append(writer.submit(write_one, ci, data, pending))
                while len(writes) >= depth:
                    writes.popleft().result()
            loop_ok = True
        finally:
            # drain every in-flight write so no writer task is abandoned;
            # the first write error surfaces unless the loop itself raised
            first: BaseException | None = None
            while writes:
                try:
                    writes.popleft().result()
                except BaseException as e:  # noqa: BLE001
                    if first is None:
                        first = e
            if first is not None and loop_ok:
                raise first


def _read_row_chunk(
    dat, start: int, block_size: int, chunk_off: int, n: int, k: int,
    out: np.ndarray, pt=None, assume_zero: bool = False,
) -> np.ndarray:
    """Gather [k, n] from the dat file into ``out``: shard i's bytes of
    this row chunk, zero-padded past EOF (ec_encoder.go:166-176). Stale
    bytes from a previous use of ``out`` are overwritten or zeroed.

    Rows land via ``readinto`` directly in ``out``. When the chunk
    covers whole blocks and ``out`` is one contiguous slab, the k rows
    are back to back in the dat file and the gather is one ``seek`` and
    one ``readinto``. ``assume_zero`` says ``out`` is already all zeros
    (a pristine slab), so EOF padding needs no fill. ``pt`` records
    ``read`` (dat-file reads) and ``stage`` (EOF zero-fill)."""
    stage_s = 0.0
    read_s = 0.0
    read_bytes = 0
    if chunk_off == 0 and n == block_size and out.flags["C_CONTIGUOUS"]:
        flat = out.reshape(k * n)
        t0 = time.perf_counter()
        dat.seek(start)
        got = dat.readinto(memoryview(flat))
        read_s = time.perf_counter() - t0
        read_bytes = got
        if got < k * n and not assume_zero:
            t0 = time.perf_counter()
            flat[got:] = 0
            stage_s += time.perf_counter() - t0
    else:
        for i in range(k):
            t0 = time.perf_counter()
            dat.seek(start + i * block_size + chunk_off)
            got = dat.readinto(memoryview(out[i]))
            read_s += time.perf_counter() - t0
            read_bytes += got
            if got < n and not assume_zero:
                t0 = time.perf_counter()
                out[i, got:] = 0
                stage_s += time.perf_counter() - t0
    if pt is not None:
        pt.add("read", read_s, read_bytes)
        pt.add("stage", stage_s, k * n)
    return out


def _write_row(f, arr: np.ndarray) -> None:
    """Append one contiguous shard row with no copy. A row that is all
    zeros (EOF padding) becomes a seek-forward hole instead of disk IO;
    callers truncate to the exact shard size at close, so trailing
    holes materialise. Holes read back as zeros."""
    if arr[:4096].any() or arr[4096:].any():
        f.write(arr)
    else:
        f.seek(arr.nbytes, 1)


def write_ec_files(
    base_file_name: str | os.PathLike,
    rs: codec_mod.RSCodec | None = None,
    large_block_size: int = C.LARGE_BLOCK_SIZE,
    small_block_size: int = C.SMALL_BLOCK_SIZE,
    batch_bytes: int | None = None,
    phases=None,
    device: str | torch.device | None = None,
) -> list[str]:
    """Generate all shard files for ``<base>.dat``; returns their paths.

    ``rs`` is the codec (default: RS(10,4) on ``device``; ``device=None``
    means the card and raises without one). ``batch_bytes`` None →
    sized from the link EWMAs (:func:`choose_pipeline`). ``phases``
    (PhaseTimer or None) accumulates read / stage / h2d / codec / write /
    flush."""
    base = os.fspath(base_file_name)
    rs = rs or codec_mod.RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device)
    return _encode_lockstep(
        rs, [base], os.path.getsize(base + ".dat"), large_block_size,
        small_block_size, batch_bytes, phases,
    )[base]


def write_ec_files_batch(
    base_file_names: list[str | os.PathLike],
    large_block_size: int = C.LARGE_BLOCK_SIZE,
    small_block_size: int = C.SMALL_BLOCK_SIZE,
    batch_bytes: int | None = None,
    mesh=None,
    data_shards: int = C.DATA_SHARDS,
    parity_shards: int = C.PARITY_SHARDS,
    phases=None,
    device: str | torch.device | None = None,
    rs: codec_mod.RSCodec | None = None,
) -> dict[str, list[str]]:
    """Encode many volumes at once on one card; returns {base: [shard
    paths]}, the files byte-identical to per-volume :func:`write_ec_files`.

    The counterpart of the reference's ``write_ec_files_batch`` with
    ``mesh=None`` on one chip (encoder.py:507-705): volumes of one
    ``.dat`` size share a row plan, so they go in lockstep; each volume's
    chunk is read into its column band of one pinned [k, V·n] slab, and
    the codec encodes the slab in one launch (GF(2^8) arithmetic is
    column-wise, so side-by-side volumes give each volume's own parity).
    Each volume has its own reader and writer worker, so the volumes'
    disk reads and shard writes overlap. ``device`` and ``rs`` are as
    for :func:`write_ec_files` (``rs``, when given, must be
    RS(data_shards, parity_shards)). A ``mesh`` (the reference's
    multi-chip branch) raises: multi-GPU encode is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "write_ec_files_batch runs on one card; the mesh branch comes "
            "with the multi-GPU compute plane (ROADMAP queue 1 item 10)"
        )
    rs = rs or codec_mod.RSCodec(data_shards, parity_shards, device)
    if (rs.data_shards, rs.parity_shards) != (data_shards, parity_shards):
        raise ValueError(
            f"codec is RS({rs.data_shards},{rs.parity_shards}), not "
            f"RS({data_shards},{parity_shards})"
        )
    # identical .dat size ⇒ identical row plan ⇒ lockstep chunks
    groups: dict[int, list[str]] = {}
    for b in base_file_names:
        b = os.fspath(b)
        groups.setdefault(os.path.getsize(b + ".dat"), []).append(b)
    result: dict[str, list[str]] = {}
    for dat_size, group in groups.items():
        result.update(_encode_lockstep(
            rs, group, dat_size, large_block_size, small_block_size,
            batch_bytes, phases,
        ))
    return result


def _encode_lockstep(rs, group: list[str], dat_size: int,
                     large_block_size: int, small_block_size: int,
                     batch_bytes: int | None,
                     phases) -> dict[str, list[str]]:
    """Encode the volumes of one ``.dat`` size in lockstep: chunk by chunk,
    volume v's chunk in column band [v·n, (v+1)·n) of one [k, V·n] slab
    from the ring, one codec launch a slab."""
    k, total = rs.data_shards, rs.total_shards
    nvol = len(group)
    batch, depth = choose_pipeline(dat_size, k, batch_bytes, volumes=nvol)
    rows = encode_row_plan(dat_size, large_block_size, small_block_size, k)
    # (row start, block size, chunk offset, chunk len) work list
    chunks = [
        (start, bs, co, min(batch, bs - co))
        for start, bs in rows
        for co in range(0, bs, batch)
    ]
    max_n = max((c[3] for c in chunks), default=0)
    if phases is not None:
        phases.note("batch_bytes", batch)
        phases.note("pipeline_depth", depth)
        if nvol > 1:
            phases.note("readers", nvol)
    paths = {b: [b + C.to_ext(i) for i in range(total)] for b in group}
    buffering = _write_buffering(nvol * total, max_n)
    # depth queued writes + 1 write-ahead read + 1 being encoded
    ring = _SlabRing(depth + 1, (k, nvol * max_n), rs.host_zeros)
    in_flight: dict[int, np.ndarray] = {}

    def read_fn(ci: int) -> np.ndarray:
        start, bs, co, n = chunks[ci]
        slab = ring.acquire()
        in_flight[ci] = slab
        pristine = ring.take_pristine(slab)
        out = slab[:, : nvol * n]

        def fill_band(vi: int) -> None:
            t0 = time.perf_counter()
            _read_row_chunk(
                dats[vi], start, bs, co, n, k,
                out=out[:, vi * n:(vi + 1) * n], pt=phases,
                assume_zero=pristine,
            )
            _DEVICE_LEDGER.record_lane(vi, time.perf_counter() - t0, k * n)

        list(readers.map(fill_band, range(nvol)))
        return out

    def write_volume(ci, data, parity, vi):
        n = chunks[ci][3]
        band = slice(vi * n, (vi + 1) * n)
        files = shard_files[vi * total:(vi + 1) * total]
        for i in range(k):
            _write_row(files[i], data[i, band])
        for j in range(total - k):
            _write_row(files[k + j], parity[j, band])

    def write_fn(ci, data, parity):
        list(writers.map(lambda vi: write_volume(ci, data, parity, vi),
                         range(nvol)))

    def release_fn(ci, data):
        ring.release(in_flight.pop(ci))

    dats = [open(b + ".dat", "rb") for b in group]
    try:
        shard_files = [open(p, "wb", buffering=buffering)
                       for b in group for p in paths[b]]
        try:
            # one reader and one writer worker per volume: the volumes'
            # reads of a chunk overlap, and so do their shard writes (each
            # volume's files are written by one worker a chunk; the
            # pipeline's one writer thread keeps the chunks in order)
            with ThreadPoolExecutor(max_workers=nvol) as readers, \
                    ThreadPoolExecutor(max_workers=nvol) as writers, \
                    launcher_for(rs) as launch:
                _run_pipeline(
                    len(chunks), read_fn, launch, write_fn, pt=phases,
                    release_fn=release_fn, depth=depth,
                )
        finally:
            # closing flushes the write buffers, timed as its own phase;
            # truncating to the exact shard size first materialises
            # trailing sparse holes
            shard_sz = sum(bs for _, bs in rows)
            t0 = time.perf_counter()
            for f in shard_files:
                try:
                    f.truncate(shard_sz)
                finally:
                    f.close()
            if phases is not None:
                phases.add("flush", time.perf_counter() - t0)
    finally:
        for f in dats:
            f.close()
    return paths


def write_sorted_file_from_idx(
    base_file_name: str | os.PathLike, ext: str = ".ecx"
) -> str:
    """``.idx`` → latest-state, needle-id-sorted ``.ecx``
    (ec_encoder.go:25-54): the append-only log folded to one live entry
    per key. Host-only; touches no device."""
    base = os.fspath(base_file_name)
    with open(base + ".idx", "rb") as f:
        entries = idx_mod.parse_entries(f.read())
    out = base + ext
    with open(out, "wb") as f:
        f.write(idx_mod.pack_entries(idx_mod.fold_entries(entries)))
    return out
