"""Per-shape route choice for the device-resident GF(2^8) product.

Counterpart of ``seaweedfs_tpu/ops/autotune.py``. For every (o, k)
coefficient shape and input kind it measures the candidate (method, tile)
pairs on the card and caches the winner, in this process and in a JSON
file of the port's own (``SEAWEEDFS_TPU_TORCH_AUTOTUNE_CACHE``, else
``<repo>/.autotune_cache_torch.json``, listed in ``.gitignore``). It never
reads the reference's ``.autotune_cache.json``, whose entries were
measured on a TPU v5e.

Input kinds (``ops/kernels/gf_kernel.gf_matmul_fused``):

* ``dev8``  — device-resident uint8. Candidates: the ``repack`` route
  (gf_repack → gf_swar → gf_unpack) over the reference's tile list, the
  ``swar`` route (gf_swar_u8) and the ``mxu`` route (gf_bitplane); the
  last two have no tile and are one candidate each (tile_n 0).
* ``dev32`` — device-resident u32 lane-packed slabs. One candidate, the
  gf_swar kernel, which has no tile: ``Choice("swar", 0)``.
* ``host``  — host numpy slabs: not measured, the transfers dominate.

Keys are ``<torch.cuda.get_device_name()>:<o>x<k>:<kind>``, so a winner
measured on one card is never applied on another. Times are medians of
CUDA-event timed calls with the L2 flushed before each (``ops/timing``).
A shape not in the cache gets the per-kind default unless
``SEAWEEDFS_TPU_TORCH_AUTOTUNE=1`` asks for a live measurement.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .timing import l2_flusher, time_ms

CACHE_ENV = "SEAWEEDFS_TPU_TORCH_AUTOTUNE_CACHE"
AUTOTUNE_ENV = "SEAWEEDFS_TPU_TORCH_AUTOTUNE"


@dataclass(frozen=True)
class Choice:
    method: str
    tile_n: int  # bytes of the repack tile; 0 for a route without a tile


# dev8: what measure() chose for every RS shape of BASELINE config 5 in
# chip_smoke.py's phase 7 on an NVIDIA H100 80GB HBM3 at its 700.00 W
# limit. RS(10,4) at [10, 16 MiB]: swar (gf_swar_u8, its compile-time
# parity form) 0.0869 ms, mxu (gf_bitplane, lane pack) 0.2372 ms, repack
# chain 0.2728-0.2732 ms over its three tiles. A u8 buffer is read as
# 16-byte words directly on this card, so the repack the TPU needs for its
# layout only adds two passes over the bytes.
DEFAULTS = {
    "dev32": Choice("swar", 0),
    "dev8": Choice("swar", 0),
    "host": Choice("swar", 0),
}
DEFAULT = DEFAULTS["dev32"]

_CACHE_PATH = os.environ.get(
    CACHE_ENV,
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        ".autotune_cache_torch.json",
    ),
)

_lock = threading.Lock()
_mem: dict[str, Choice] = {}  # guarded-by: _lock
_times: dict[str, dict[str, float]] = {}  # guarded-by: _lock
_loaded = False  # guarded-by: _lock

REPACK_TILES = (32768, 65536, 131072)  # bytes, the reference's list
MEASURE_SHARD_BYTES = 1 << 24
_REPS = 10


def _device_name() -> str:
    return torch.cuda.get_device_name()


def _key(o: int, k: int, kind: str) -> str:
    return f"{_device_name()}:{o}x{k}:{kind}"


def _load() -> None:
    global _loaded
    with _lock:
        if _loaded:
            return
        if os.path.exists(_CACHE_PATH):
            try:
                with open(_CACHE_PATH) as f:
                    for key, v in json.load(f).items():
                        _mem[key] = Choice(v["method"], int(v["tile_n"]))
                        _times[key] = dict(v.get("candidates_ms", {}))
            except (OSError, ValueError, KeyError, TypeError, AttributeError):
                pass
        _loaded = True


def _save() -> None:
    """Write the cache; the caller holds ``_lock``."""
    try:
        with open(_CACHE_PATH, "w") as f:
            json.dump(
                {
                    key: {"method": c.method, "tile_n": c.tile_n,
                          "candidates_ms": _times.get(key, {})}
                    for key, c in sorted(_mem.items())
                },
                f,
                indent=1,
            )
    except OSError:
        pass


def _coeff_for(o: int, k: int) -> np.ndarray:
    """An o×k matrix as real dispatches use: the parity rows of RS(k, o)
    for o ≤ k, the full systematic RS(k, o−k) matrix for o > k."""
    from . import gf256

    if o <= k:
        return gf256.parity_matrix(k, o)
    return gf256.rs_matrix(k, o - k)


def candidates(kind: str) -> list[Choice]:
    """The (method, tile) pairs ``measure`` times for an input kind."""
    if kind == "dev8":
        return [Choice("repack", t) for t in REPACK_TILES] + [
            Choice("swar", 0), Choice("mxu", 0)]
    if kind == "dev32":
        return [Choice("swar", 0)]
    raise ValueError(f"kind {kind!r} is not measured")


def candidate_times(o: int, k: int, kind: str = "dev8",
                    shard_bytes: int = MEASURE_SHARD_BYTES) -> dict[str, float]:
    """Milliseconds of each candidate on [k, shard_bytes] random bytes made
    on the card, keyed ``<method>/<tile_n>``. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotune measures on a CUDA device; none found")
    from .kernels import gf_kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    coeff = np.ascontiguousarray(_coeff_for(o, k), dtype=np.uint8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    data = torch.randint(0, 256, (k, shard_bytes), dtype=torch.uint8,
                         device=dev, generator=gen)
    if kind == "dev32":
        data = data.view(torch.int32)
    flush = l2_flusher(dev)
    out = {}
    for c in candidates(kind):
        def run(c=c):
            gf_kernel.gf_matmul_fused(coeff, data, method=c.method,
                                      tile_n=c.tile_n or None)
        out[f"{c.method}/{c.tile_n}"] = time_ms(run, _REPS, flush=flush)
    return out


def measure(o: int, k: int, kind: str = "dev8",
            shard_bytes: int = MEASURE_SHARD_BYTES) -> Choice:
    """Measure every candidate for one (shape, input kind) on the card and
    return the fastest; ``host`` is not measured and gets its default."""
    if kind == "host":
        return DEFAULTS["host"]
    times = candidate_times(o, k, kind, shard_bytes)
    best_key = min(times, key=times.get)
    method, tile = best_key.split("/")
    with _lock:
        _times[_key(o, k, kind)] = times
    return Choice(method, int(tile))


def measured_times(o: int, k: int, kind: str) -> dict[str, float]:
    """The candidate times behind the cached choice for a shape, if it was
    measured (in this process or by the run that wrote the cache)."""
    _load()
    with _lock:
        return dict(_times.get(_key(o, k, kind), {}))


def best(o: int, k: int, kind: str = "dev32") -> Choice:
    """Tuned (method, tile) for a coefficient shape [o, k] + input kind.

    Without a card it returns the kind's default, as the reference does
    off its chip; it does not raise, because it chooses and runs nothing:
    the entry point that calls it raises without a card."""
    if kind == "host" or not torch.cuda.is_available():
        return DEFAULTS.get(kind, DEFAULT)
    _load()
    key = _key(o, k, kind)
    with _lock:
        if key in _mem:
            return _mem[key]
    if os.environ.get(AUTOTUNE_ENV) != "1":
        return DEFAULTS.get(kind, DEFAULT)
    choice = measure(o, k, kind)
    with _lock:
        _mem[key] = choice
        _save()
    return choice


def tune_shapes(shapes, kinds=("dev32", "dev8"),
                force: bool = False) -> dict[str, Choice]:
    """Tune (o, k) shapes × input kinds explicitly. Measurement runs
    outside the lock so concurrent ``best()`` lookups are not blocked."""
    _load()
    for o, k in shapes:
        for kind in kinds:
            key = _key(o, k, kind)
            with _lock:
                have = key in _mem
            if force or not have:
                choice = measure(o, k, kind)
                with _lock:
                    _mem[key] = choice
                    _save()
    with _lock:
        return dict(_mem)
