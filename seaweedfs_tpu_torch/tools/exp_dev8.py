"""The device-u8 route sweep of ``tools/exp_dev8.py`` on the card.

    python -m seaweedfs_tpu_torch.tools.exp_dev8 [--shard-mib 64]

The reference asked which way of feeding device-resident u8 shards to
the SWAR algebra is fastest (dev8 was 52.7 GB/s through mxu against
293.9 for host-packed u32 swar on the TPU). Its candidates, at its size
of RS(10,4) parity over [10, 64 MiB]:

- the u32 swar kernel on host-packed words (the flagship) and the bit-
  plane route on u8 (then the dev8 default);
- A: an XLA bitcast to u32 feeding the swar kernel. On the card a u8
  tensor's bytes are its words already: a free ``view(torch.int32)``;
- B: a repack kernel (``repack_kernel`` :31, one row at a time) feeding
  the swar kernel, tiles 8192 and 32768: ``gf_repack`` (the same words as
  the reference's block repack, shown in interpret mode by
  tests/test_torch_sweep_kernels.py) feeding ``gf_swar``. The product
  stays in u32 words, as the reference's did;
- C: the in-kernel regrouping kernel at tiles 8192/32768/65536:
  ``gf_swar_u8``, which has no tile, so one row.

The port adds one row, the ``vpu`` route (``gf_vpu``), which the
reference keeps for comparison.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import gf256
from ..ops.kernels import (
    gf_bitplane,
    gf_kernel,
    gf_repack,
    gf_swar,
    gf_swar_u8,
    gf_vpu,
)
from . import Sweep

MIB = 1 << 20


def main(device=None, shard_bytes: int = 64 * MIB, reps: int = 10,
         seed: int = 0) -> list[dict]:
    k, m = 10, 4
    coeff = np.ascontiguousarray(gf256.parity_matrix(k, m), np.uint8)
    sc = gf_swar.coeff_from_reference(coeff)
    sw = Sweep(f"exp_dev8 RS({k},{m}) [{k}, {shard_bytes}] u8", device,
               reps, seed)
    n = shard_bytes
    total = k * n
    x8 = sw.rand_bytes(k, n)
    words = x8.view(torch.int32)
    want = gf_swar.gf_matmul_plain(sc, x8)  # [m, n] u8
    want_words = want.view(torch.int32)

    sw.row("u32 swar (host-packed input) [flagship]: gf_swar",
           lambda: gf_kernel.u32_route(sc, words), want_words, total)
    sw.row("mxu (u8 device input) [current dev8]: gf_bitplane",
           lambda: gf_bitplane.gf_matmul(coeff, x8), want, total)
    sw.row("swar-u8 in-kernel bitcast: gf_swar_u8 (the TPU's tile 16384: "
           "none here)", lambda: gf_swar_u8.gf_matmul(sc, x8), want, total)
    sw.row("vpu, one byte per 32-bit lane [kept for comparison]: gf_vpu",
           lambda: gf_vpu.gf_matmul(sc, x8), want, total)
    sw.row("A: x8.view(int32) -> u32 swar (free on the card; XLA needed a "
           "relayout)", lambda: gf_swar.gf_matmul(sc, words.view(
               torch.uint8)).view(torch.int32), want_words, total)
    for tile in (8192, 32768):
        want_b = gf_repack.repack_plain(want, tile)
        sw.row(f"B: repack(tile={tile}) -> u32 swar: gf_repack, gf_swar",
               lambda tile=tile: gf_swar.gf_matmul(
                   sc, gf_repack.repack(x8, tile).view(torch.uint8)
               ).view(torch.int32), want_b, total)
    sw.row("C: swar-u8 tiles 8192/32768/65536: gf_swar_u8 has no tile, one "
           "row", lambda: gf_swar_u8.gf_matmul(sc, x8), want, total)
    return sw.rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shard-mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    main(shard_bytes=args.shard_mib * MIB, reps=args.reps)
