"""Rebuild missing shard files from survivors on the port's codec.

The port's counterpart of ``seaweedfs_tpu/storage/erasure_coding/
rebuild.py`` (SeaweedFS weed/storage/erasure_coding/ec_encoder.go:61-118,
233-287): shards present on disk are inputs; every absent ``.ecNN`` is
regenerated by windowed reconstruction, with the next window read ahead
on a worker thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...ops import codec as codec_mod
from . import constants as C

DEFAULT_WINDOW_BYTES = 8 * 1024 * 1024


def rebuild_ec_files(
    base_file_name: str | os.PathLike,
    rs: codec_mod.RSCodec | None = None,
    window_bytes: int = DEFAULT_WINDOW_BYTES,
    device: str | torch.device | None = None,
) -> list[int]:
    """Regenerate every missing ``<base>.ecNN``; returns rebuilt shard
    ids. ``rs`` is the codec (default: RS(10,4) on ``device``;
    ``device=None`` means the card and raises without one)."""
    base = os.fspath(base_file_name)
    rs = rs or codec_mod.RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device)
    total = rs.total_shards
    present = [
        i for i in range(total) if os.path.exists(base + C.to_ext(i))
    ]
    missing = [i for i in range(total) if i not in present]
    if not missing:
        return []
    if len(present) < rs.data_shards:
        raise ValueError(
            f"need >= {rs.data_shards} shards to rebuild {base}, "
            f"have {len(present)}"
        )
    shard_size = os.path.getsize(base + C.to_ext(present[0]))
    use = present[: rs.data_shards]
    # two window buffers from the codec (pinned on ``cuda``, so a window
    # goes H2D with no staging copy): the reader fills one while the
    # other is reconstructed. A window is the front of a flat buffer, so
    # the shorter last one is contiguous too.
    width = min(window_bytes, shard_size)
    flats = [rs.host_zeros((len(use) * width,)) for _ in range(2)]
    ins = {i: open(base + C.to_ext(i), "rb") for i in use}
    outs = {i: open(base + C.to_ext(i), "wb") for i in missing}

    def read_window(wi: int, off: int, n: int) -> np.ndarray:
        stack = flats[wi % 2][: len(use) * n].reshape(len(use), n)
        for row, sid in enumerate(use):
            ins[sid].seek(off)
            got = ins[sid].readinto(memoryview(stack[row]))
            stack[row, got:] = 0
        return stack

    try:
        offsets = list(range(0, shard_size, window_bytes))
        with ThreadPoolExecutor(max_workers=1) as reader:
            nxt = None
            for wi, off in enumerate(offsets):
                n = min(window_bytes, shard_size - off)
                stack = (
                    nxt.result() if nxt is not None
                    else read_window(wi, off, n)
                )
                if wi + 1 < len(offsets):
                    off2 = offsets[wi + 1]
                    nxt = reader.submit(
                        read_window, wi + 1, off2,
                        min(window_bytes, shard_size - off2),
                    )
                else:
                    nxt = None
                shards_in = {sid: stack[row] for row, sid in enumerate(use)}
                rebuilt = rs.reconstruct(shards_in, wanted=missing)
                for sid in missing:
                    outs[sid].write(rebuilt[sid])
    finally:
        for f in ins.values():
            f.close()
        for f in outs.values():
            f.close()
    return missing
