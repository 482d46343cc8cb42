"""The batched-volume geometry sweep of ``tools/exp_batched.py`` on the
card.

    python -m seaweedfs_tpu_torch.tools.exp_batched [--shard-mib 64]
        [--volumes 8]

The reference asked why 8 volumes batched as [V, k, n] ran at half the
single-volume rate on the TPU, and which formulation of the u32 swar
kernel to use, at equal work: one volume of [10, 16 Mi] words (64 MiB
shards) against 8 volumes of [10, 2 Mi] words (8 MiB shards). Its
candidates: the single-volume kernel at two tiles; the batched kernel
with grid (V, n) at three tiles; the same with the batch as the fastest
grid axis (``build_batched_swapped`` :64); and one program over all V
volumes (``_swar_fusedv_kernel`` :27) at three tiles. Its answer shaped
the multi-volume encode: lane-packing volumes into one [k, V·n] slab
(seaweedfs_tpu/storage/erasure_coding/encoder.py:548-556).

On the card: ``gf_swar`` (its batch on gridDim.y), its batch-fastest
launch and ``gf_swar_fusedv``. None has a tile (a thread takes one
16-byte column word), so each TPU tile sweep is one row.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import gf256
from ..ops.kernels import gf_kernel, gf_swar
from . import Sweep

MIB = 1 << 20


def main(device=None, shard_bytes: int = 64 * MIB, volumes: int = 8,
         reps: int = 10, seed: int = 0) -> list[dict]:
    k, m = 10, 4
    coeff = np.ascontiguousarray(gf256.parity_matrix(k, m), np.uint8)
    sc = gf_swar.coeff_from_reference(coeff)
    n4 = shard_bytes // 4
    n4_b = n4 // volumes
    sw = Sweep(f"exp_batched RS({k},{m}) [{k}, {n4}] u32 single, "
               f"[{volumes}, {k}, {n4_b}] batched", device, reps, seed)
    single = sw.rand_bytes(k, 4 * n4).view(torch.int32)
    batch = sw.rand_bytes(volumes, k, 4 * n4_b).view(torch.int32)
    small = batch[0]

    def plain(words):
        return gf_swar.gf_matmul_plain(sc, words.view(torch.uint8)).view(
            torch.int32)

    want_single, want_batch = plain(single), plain(batch)
    total = k * n4 * 4
    sw.row(f"single [{k},{n4}] words, TPU tiles 16384/32768: gf_swar (no "
           "tile)", lambda: gf_kernel.u32_route(sc, single),
           want_single, total)
    sw.row(f"single [{k},{n4_b}] words (one volume of the batch): gf_swar",
           lambda: gf_kernel.u32_route(sc, small), want_batch[0],
           k * n4_b * 4)
    sw.row("batched grid(V,n), TPU tiles 8192/16384/32768: gf_swar",
           lambda: gf_kernel.u32_route(sc, batch),
           want_batch, volumes * k * n4_b * 4)
    sw.row("batched swapped grid(n,V): gf_swar batch-fastest launch",
           lambda: gf_swar.gf_matmul_batch_fastest(sc, batch), want_batch,
           volumes * k * n4_b * 4)
    sw.row("fusedV one program, TPU tiles 2048/4096/8192: gf_swar_fusedv",
           lambda: gf_swar.gf_matmul_fusedv(sc, batch), want_batch,
           volumes * k * n4_b * 4)
    return sw.rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shard-mib", type=int, default=64)
    ap.add_argument("--volumes", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    main(shard_bytes=args.shard_mib * MIB, volumes=args.volumes,
         reps=args.reps)
