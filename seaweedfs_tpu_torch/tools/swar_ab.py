"""Time gf_swar, gf_swar_u8, gf_bitplane or gf_vpu of two checkouts of
this repository on one card, in turns.

    python seaweedfs_tpu_torch/tools/swar_ab.py --parent DIR [--reps 20]
        [--kernel gf_swar|gf_swar_u8|gf_bitplane|gf_vpu]

``DIR`` is the root of another checkout of the repository (an earlier
commit, unpacked with ``git archive``). The script runs its worker four
times, each in a fresh process that imports the port from one root: the
other checkout, this one, this one, the other. Each worker builds that
checkout's kernel from its own sources and times it with that
checkout's ``ops/timing.time_ms`` (CUDA events, L2 flushed) at the
shapes the port launches it with. gf_swar (the default):

- ``[10, 1 MiB]`` RS(10,4) parity, one ``ec.encode`` row;
- ``[10, 8 MiB]`` reconstruction of shards {0,5,11,13}, one rebuild window;
- ``[10, 64 MiB]`` RS(10,4) parity, the device-resident slab;
- ``[8, 10, 2 Mi]`` u32 words of the parity through the three launch forms
  (the batch on a grid axis, batch-fastest, one thread over all volumes).

The worker calls only what every checkout since the first word forms has
(``gf_swar.launch``, ``coeff_from_reference``, the two word forms,
``gf_kernel.u32_route``); in a checkout whose wrapper chooses a column
width and a coefficient form (``gf_swar.launch_plan``) it also times the
run-time form at W = 1 and at the chosen W, and the compile-time form at
each W its kernel has, so each design step shows on its own.

gf_swar_u8 (``--kernel gf_swar_u8``), the device-resident u8 route, through
``gf_swar_u8.gf_matmul`` at the plan its wrapper chooses:

- ``[10, 1 MiB]`` RS(10,4) parity;
- ``[10, 8 MiB]`` reconstruction of shards {0,5,11,13};
- ``[10, 64 MiB]`` parity and reconstruction, the device-resident slab;
- ``[8, 10, 64 MiB]`` parity, the 8-volume batch.

In a checkout whose wrapper takes a ``width`` it also times each
coefficient form at each W, forced.

gf_bitplane (``--kernel gf_bitplane``), the ``mxu`` route, through
``gf_bitplane.gf_matmul``, each output checked against gf_swar's plain
version on the card:

- ``[10, 64 MiB]`` RS(10,4) parity and reconstruction of {0,5,11,13};
- ``[6, 32 MiB]`` RS(6,3) and ``[20, 32 MiB]`` RS(20,4) parity, the sweep;
- ``[10, 1 MiB]`` parity;
- ``[8, 10, 64 MiB]`` parity, the 8-volume batch (~8 GB of device memory).

gf_vpu (``--kernel gf_vpu``), the ``vpu`` route, through
``gf_vpu.gf_matmul``, each output checked against gf_swar's plain
version on the card:

- ``[10, 64 MiB]`` RS(10,4) parity and reconstruction of {0,5,11,13};
- ``[10, 8 MiB]`` reconstruction of {0,5,11,13} and ``[10, 1 MiB]``
  parity, a rebuild window and an encode row;
- ``[16, 64, 1 MiB]``: a random 16 x 64 matrix, the kernel's widest.

Every mode prints the card's name and power limit, a table of every
shape's times by run, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

MIB = 1 << 20


def worker(root: str, reps: int, seed: int, kernel: str) -> dict:
    """Times of the checkout at ``root``, in ms by label."""
    sys.path.insert(0, root)
    if kernel == "gf_swar_u8":
        return _u8_times(reps, seed)
    if kernel == "gf_bitplane":
        return _bitplane_times(reps, seed)
    if kernel == "gf_vpu":
        return _vpu_times(reps, seed)
    return _swar_times(root, reps, seed)


def _swar_times(root: str, reps: int, seed: int) -> dict:
    import dataclasses

    import torch

    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.kernels import gf_kernel, gf_swar
    from seaweedfs_tpu_torch.ops.timing import l2_flusher, time_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = l2_flusher(dev)
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rec = gf256.reconstruction_matrix(10, 4, present)[0]
    parity = gf256.parity_matrix(10, 4)
    forms = hasattr(gf_swar, "launch_plan")
    times = {}
    for label, matrix, n in (("encode [10,1MiB]", parity, MIB),
                             ("rebuild {0,5,11,13} [10,8MiB]", rec, 8 * MIB),
                             ("encode [10,64MiB]", parity, 64 * MIB)):
        coeff = gf_swar.coeff_from_reference(matrix)
        x = torch.randint(0, 256, (1, 10, n), dtype=torch.uint8, device=dev,
                          generator=gen)
        out = torch.empty((1, 4, n), dtype=torch.uint8, device=dev)
        want = gf_swar.gf_matmul_plain(coeff, x)
        variants = [("", coeff, None)]
        if forms:
            runtime = dataclasses.replace(coeff, rs10x4=False)
            variants += [(" run-time W=1", runtime, 1),
                         (" run-time W chosen", runtime, None)]
            if coeff.rs10x4:
                variants += [
                    (f" constants W={w}", coeff, w) for w in range(
                        1, gf_swar.max_width(4, gf_swar.FORM_RS10X4) + 1)]
        for suffix, c, width in variants:
            kw = {} if width is None else {"width": width}
            gf_swar.launch(c, x, out, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{root}: {label}{suffix} differs from "
                                     "the plain version")
            times[label + suffix] = time_ms(
                lambda c=c, kw=kw: gf_swar.launch(c, x, out, **kw), reps, 3,
                flush)
        del x, out, want
    words = torch.randint(0, 256, (8, 10, 8 * MIB), dtype=torch.uint8,
                          device=dev, generator=gen).view(torch.int32)
    coeff = gf_swar.coeff_from_reference(parity)
    want = gf_swar.gf_matmul_plain(coeff, words.view(torch.uint8))
    for label, fn in (("[8,10,2Mi] words, batch on grid.y",
                       gf_kernel.u32_route),
                      ("[8,10,2Mi] words, batch-fastest",
                       gf_swar.gf_matmul_batch_fastest),
                      ("[8,10,2Mi] words, fused volumes",
                       gf_swar.gf_matmul_fusedv)):
        if not torch.equal(fn(coeff, words).view(torch.uint8), want):
            raise AssertionError(f"{root}: {label} differs from the plain "
                                 "version")
        times[label] = time_ms(lambda fn=fn: fn(coeff, words), reps, 3, flush)
    return times


def _u8_times(reps: int, seed: int) -> dict:
    import dataclasses
    import inspect

    import torch

    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.kernels import gf_swar, gf_swar_u8
    from seaweedfs_tpu_torch.ops.timing import l2_flusher, time_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = l2_flusher(dev)
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rec = gf256.reconstruction_matrix(10, 4, present)[0]
    parity = gf256.parity_matrix(10, 4)
    forms = "width" in inspect.signature(gf_swar_u8.gf_matmul).parameters
    times = {}
    for label, matrix, shape in (
            ("encode [10,1MiB]", parity, (10, MIB)),
            ("rebuild {0,5,11,13} [10,8MiB]", rec, (10, 8 * MIB)),
            ("encode [10,64MiB]", parity, (10, 64 * MIB)),
            ("rebuild {0,5,11,13} [10,64MiB]", rec, (10, 64 * MIB)),
            ("encode [8,10,64MiB]", parity, (8, 10, 64 * MIB))):
        coeff = gf_swar.coeff_from_reference(matrix)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        want = gf_swar.gf_matmul_plain(coeff, x)
        variants = [("", coeff, {})]
        if forms:
            by_form = [("run-time", dataclasses.replace(coeff, rs10x4=False),
                        gf_swar.FORM_RUNTIME)]
            if coeff.rs10x4:
                by_form.insert(0, ("constants", coeff, gf_swar.FORM_RS10X4))
            variants += [(f" {name} W={w}", c, {"width": w})
                         for name, c, form in by_form
                         for w in range(1, gf_swar.max_width(4, form) + 1)]
        for suffix, c, kw in variants:
            if not torch.equal(gf_swar_u8.gf_matmul(c, x, **kw), want):
                raise AssertionError(f"gf_swar_u8 {label}{suffix} differs "
                                     "from the plain version")
            times[label + suffix] = time_ms(
                lambda c=c, kw=kw: gf_swar_u8.gf_matmul(c, x, **kw), reps, 3,
                flush)
        del x, want
    return times


def _bitplane_times(reps: int, seed: int) -> dict:
    import torch

    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.kernels import gf_bitplane, gf_swar
    from seaweedfs_tpu_torch.ops.timing import l2_flusher, time_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = l2_flusher(dev)
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rec = gf256.reconstruction_matrix(10, 4, present)[0]
    parity = gf256.parity_matrix(10, 4)
    times = {}
    for label, matrix, shape in (
            ("encode [10,64MiB]", parity, (10, 64 * MIB)),
            ("rebuild {0,5,11,13} [10,64MiB]", rec, (10, 64 * MIB)),
            ("RS(6,3) [6,32MiB]", gf256.parity_matrix(6, 3), (6, 32 * MIB)),
            ("RS(20,4) [20,32MiB]", gf256.parity_matrix(20, 4),
             (20, 32 * MIB)),
            ("encode [10,1MiB]", parity, (10, MIB)),
            ("encode [8,10,64MiB]", parity, (8, 10, 64 * MIB))):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        want = gf_swar.gf_matmul_plain(gf_swar.coeff_from_reference(matrix),
                                       x)
        if not torch.equal(gf_bitplane.gf_matmul(matrix, x), want):
            raise AssertionError(f"gf_bitplane {label} differs from the "
                                 "plain version")
        times[label] = time_ms(lambda: gf_bitplane.gf_matmul(matrix, x),
                               reps, 3, flush)
        del x, want
    return times


def _vpu_times(reps: int, seed: int) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.kernels import gf_swar, gf_vpu
    from seaweedfs_tpu_torch.ops.timing import l2_flusher, time_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = l2_flusher(dev)
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rec = gf256.reconstruction_matrix(10, 4, present)[0]
    parity = gf256.parity_matrix(10, 4)
    wide = np.random.default_rng(seed).integers(0, 256, (16, 64),
                                                dtype=np.uint8)
    times = {}
    for label, matrix, shape in (
            ("encode [10,64MiB]", parity, (10, 64 * MIB)),
            ("rebuild {0,5,11,13} [10,64MiB]", rec, (10, 64 * MIB)),
            ("rebuild {0,5,11,13} [10,8MiB]", rec, (10, 8 * MIB)),
            ("encode [10,1MiB]", parity, (10, MIB)),
            ("random 16x64 [64,1MiB]", wide, (64, MIB))):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        want = gf_swar.gf_matmul_plain(gf_swar.coeff_from_reference(matrix),
                                       x)
        if not torch.equal(gf_vpu.gf_matmul(matrix, x), want):
            raise AssertionError(f"gf_vpu {label} differs from the plain "
                                 "version")
        times[label] = time_ms(lambda: gf_vpu.gf_matmul(matrix, x), reps, 3,
                               flush)
        del x, want
    return times


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel",
                    choices=("gf_swar", "gf_swar_u8", "gf_bitplane",
                             "gf_vpu"),
                    default="gf_swar")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        # this script's own directory must not shadow the checkout's modules
        sys.path[:] = [p for p in sys.path
                       if os.path.abspath(p or ".") != os.path.dirname(
                           os.path.abspath(__file__))]
        print(json.dumps(worker(args.worker, args.reps, args.seed,
                                args.kernel)), flush=True)
        return 0

    here = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))
    card = card_label()
    print(card, flush=True)
    parent = os.path.abspath(args.parent)
    runs = []
    for name, root in (("parent", parent), ("change", here),
                       ("change", here), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", parent,
             "--reps", str(args.reps), "--seed", str(args.seed),
             "--kernel", args.kernel, "--worker", root],
            cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"run {len(runs)} ({name}, {root}): done", flush=True)
    labels = list(dict.fromkeys(k for _, t in runs for k in t))
    table = {}
    print("ms by run (parent, change, change, parent), median of each tree:")
    for label in labels:
        by = {"parent": [], "change": []}
        for name, t in runs:
            if label in t:
                by[name].append(t[label])
        row = {name: statistics.median(v) for name, v in by.items() if v}
        table[label] = {"runs": [t.get(label) for _, t in runs], **row}
        cells = ", ".join("-" if t.get(label) is None else f"{t[label]:.4f}"
                          for _, t in runs)
        print(f"  {label}: {cells}" + "".join(
            f"; {name} {ms:.4f}" for name, ms in row.items()))
    print(json.dumps({"swar_ab": table, "kernel": args.kernel,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
