"""The second device-u8 route sweep, ``tools/exp_dev8b.py``, on the card.

    python -m seaweedfs_tpu_torch.tools.exp_dev8b [--shard-mib 64]

The reference's round 2 of the dev8 question, RS(10,4) parity over
[10, 64 MiB]: the u32 swar flagship, the bit-plane route, two repack
kernels feeding the u32 swar kernel (``repack_rows`` :23, one row at a
time, and ``repack_block`` :32, one whole-block bitcast) at tiles of 32,
64 and 128 KiB, and ``fused_u8_kernel`` (:54), which repacks, computes
and unpacks in one pass, at tiles of 8, 16 and 32 KiB. Its answer set
the TPU's device-u8 default ("repack-chain 121 vs mxu 47 vs in-loop
swar-u8 25", seaweedfs_tpu/ops/autotune.py:44-50).

On the card both repack kernels are ``gf_repack`` (they give the same
words, shown in interpret mode by tests/test_torch_sweep_kernels.py), so
the two rows of a tile run the same kernels; the fused kernel is
``gf_fused_u8``. The repack rows' product stays in u32 words, as the
reference's did; the fused rows give the plain u8 product.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import gf256
from ..ops.kernels import (
    gf_bitplane,
    gf_fused_u8,
    gf_kernel,
    gf_repack,
    gf_swar,
)
from . import Sweep

MIB = 1 << 20


def main(device=None, shard_bytes: int = 64 * MIB, reps: int = 10,
         seed: int = 0) -> list[dict]:
    k, m = 10, 4
    coeff = np.ascontiguousarray(gf256.parity_matrix(k, m), np.uint8)
    sc = gf_swar.coeff_from_reference(coeff)
    sw = Sweep(f"exp_dev8b RS({k},{m}) [{k}, {shard_bytes}] u8", device,
               reps, seed)
    n = shard_bytes
    total = k * n
    x8 = sw.rand_bytes(k, n)
    words = x8.view(torch.int32)
    want = gf_swar.gf_matmul_plain(sc, x8)  # [m, n] u8

    sw.row("u32 swar flagship: gf_swar",
           lambda: gf_kernel.u32_route(sc, words),
           want.view(torch.int32), total)
    sw.row("mxu [current dev8]: gf_bitplane",
           lambda: gf_bitplane.gf_matmul(coeff, x8), want, total)
    for which in ("rows", "block"):
        for tile in (32768, 65536, 131072):
            want_w = gf_repack.repack_plain(want, tile)
            sw.row(f"repack-{which} tile={tile} -> u32 swar: gf_repack, "
                   "gf_swar",
                   lambda tile=tile: gf_swar.gf_matmul(
                       sc, gf_repack.repack(x8, tile).view(torch.uint8)
                   ).view(torch.int32), want_w, total)
    for tile in (8192, 16384, 32768):
        sw.row(f"fused block-repack swar tile={tile}: gf_fused_u8",
               lambda tile=tile: gf_fused_u8.gf_matmul(sc, x8, tile), want,
               total)
    return sw.rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shard-mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    main(shard_bytes=args.shard_mib * MIB, reps=args.reps)
