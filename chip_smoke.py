#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--volume-mib 1024] [--workdir DIR]

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``. Phases, each of which must pass:

1. header: the card's name and power limit, CUDA and nvcc versions, and
   the build of every kernel from the sources in the checkout;
2. every kernel against its plain PyTorch version on the card, byte for
   byte, at the shapes the main path gives it;
3. kernel timing with CUDA events (L2 flushed between launches) beside
   the plain version's time and the card's bound for the same work;
4. the vendored golden fixture (tests/golden/1.*): encode, ``.ecx`` and
   a 4-shard rebuild byte-identical to the golden shards;
5. the main path at full size: a ``.dat`` volume made from ``--seed``
   (1 GiB by default) through ``write_ec_files`` →
   ``write_sorted_file_from_idx`` → ``rebuild_ec_files`` of shards
   {0, 5, 11, 13} and of {3}, every parity row checked against the plain
   version on the card and every rebuilt shard against its original
   hash; launch counts read around the run prove it went through the
   kernels;
6. a second encode of the volume under torch.profiler: device time by
   kind (kernel, H2D, D2H) and the device's busy and idle share.

It prints one JSON line describing every kernel, then, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM at its 700 W limit: HBM3 bandwidth
# (NVIDIA data sheet), and the rate of each integer pipe, 132 SMs x 64
# results a clock x 1.98 GHz boost clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0: 32-bit
# integer shift, bitwise operation and multiply-add). The integer ALU
# pipe (SHF, LOP3) and the FMA pipe (IMAD) run side by side; the four
# schedulers' issue rate, 128 a clock, cannot bind while each pipe
# takes 64.
HBM_BYTES_PER_S = 3.35e12
INT_PIPE_OPS_PER_S = 132 * 64 * 1.98e9
# The instructions of one SWAR doubling of a u32, by pipe, as the built
# kernel does it (cuobjdump -sass; sass_doubling() checks them on every
# run). One XOR into an accumulator is one more LOP3 on the ALU pipe.
DOUBLING_FORMS = {
    "SHF.R x>>7": ("alu", r"SHF\.R\.U32\.HI R\d+, RZ, 0x7, R\d+"),
    "LOP3 &0x01010101": ("alu", r"LOP3\.LUT R\d+, R\d+, 0x1010101, RZ, 0xc0"),
    "LOP3 (x<<1&0xfefefefe)^t": (
        "alu", r"LOP3\.LUT R\d+, R\d+, 0xfefefefe, R\d+, 0x78"),
    "IMAD.SHL x<<1": ("fma", r"IMAD\.SHL\.U32 R\d+, R\d+, 0x2, RZ"),
    "IMAD *0x1d": ("fma", r"IMAD R\d+, R\d+, 0x1d, RZ"),
}
ALU_PER_DOUBLING = sum(p == "alu" for p, _ in DOUBLING_FORMS.values())
FMA_PER_DOUBLING = sum(p == "fma" for p, _ in DOUBLING_FORMS.values())

MIB = 1 << 20
GOLDEN_BLOCKS = dict(large_block_size=10_000, small_block_size=100,
                     batch_bytes=4096)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def sass_doubling(nvcc: str, lib_path: str) -> dict[str, int]:
    """How often each instruction form of DOUBLING_FORMS appears in the
    built SASS of gf_swar_kernel<4>, the instantiation that encode and
    rebuild launch."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    body = sass.split("gf_swar_kernelILi4E", 1)[1].split("Function :", 1)[0]
    return {name: len(re.findall(pattern, body))
            for name, (_, pattern) in DOUBLING_FORMS.items()}


def swar_work(matrix: np.ndarray, n_bytes: int, batch: int = 1):
    """(bytes moved, ALU-pipe ops, FMA-pipe ops) of one kernel call:
    each input byte read once and each output byte written once; per u32
    word, one doubling per coefficient bit past the first of each input
    row and one XOR per set coefficient bit."""
    o, k = matrix.shape
    tops = [int(c).bit_length() for c in np.bitwise_or.reduce(matrix, axis=0)]
    xtimes = sum(max(0, t - 1) for t in tops)
    xors = int(np.unpackbits(matrix).sum())
    words = batch * (-(-n_bytes // 4))
    moved = batch * (k + o) * n_bytes
    return (moved, words * (ALU_PER_DOUBLING * xtimes + xors),
            words * FMA_PER_DOUBLING * xtimes)


def bound(moved: int, alu: int, fma: int) -> tuple[float, str]:
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(alu, fma) / INT_PIPE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median milliseconds of ``fn()`` on the current stream, timed with
    CUDA events, with the L2 flushed before every timed call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_activity(torch, fn):
    """Run ``fn`` under torch.profiler; returns (wall s, device seconds
    by kind — gf_swar kernel, H2D, D2H, other — and the seconds the
    device was busy with any of them, the union of their intervals).
    Busy is None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind = {"kernel": 0.0, "h2d": 0.0, "d2h": 0.0, "other": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end  # microseconds
        spans.append((start, end))
        kind = ("kernel" if "gf_swar" in e.name else
                "h2d" if "HtoD" in e.name else
                "d2h" if "DtoH" in e.name else "other")
        by_kind[kind] += (end - start) / 1e6
    if not spans:
        return wall, by_kind, None
    busy = 0.0
    cur_start, cur_end = None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return wall, by_kind, busy / 1e6


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(16 * MIB)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def make_volume(base: str, size: int, seed: int) -> bytes:
    """Write ``<base>.dat`` of ``size`` random bytes and a ``<base>.idx``
    log over it (live needles, overwrites, tombstones) from ``seed``;
    returns the ``.ecx`` bytes the fold must give, computed here by a
    plain dict walk of the log."""
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        left = size
        while left:
            n = min(left, 64 * MIB)
            f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            left -= n
    n_needles = max(1, size // (64 * 1024))
    keys = rng.choice(1 << 40, size=n_needles, replace=False).astype(np.uint64)
    offsets = np.sort(rng.integers(1, size // 8, n_needles)) * 8
    sizes = rng.integers(1, 1 << 20, n_needles).astype(np.int32)
    log = list(zip(keys.tolist(), offsets.tolist(), sizes.tolist()))
    for i in rng.choice(n_needles, size=n_needles // 10, replace=False):
        key = log[int(i)][0]
        if i % 2:
            log.append((key, 0, -1))  # tombstone
        else:
            log.append((key, int(rng.integers(1, size // 8)) * 8, 4096))
    with open(base + ".idx", "wb") as f:
        for key, off, sz in log:
            f.write(struct.pack(">QIi", key, off // 8, sz))
    live: dict[int, tuple[int, int]] = {}
    for key, off, sz in log:
        if off == 0 or sz < 0:
            live.pop(key, None)
        else:
            live[key] = (off, sz)
    return b"".join(
        struct.pack(">QIi", key, off // 8, sz)
        for key, (off, sz) in sorted(live.items())
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024,
                    help="size of the generated .dat volume")
    ap.add_argument("--workdir", default=None,
                    help="where the volume and shards go (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.ops.kernels import build, gf_swar
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        constants as C,
        encoder,
        layout,
        rebuild,
    )
    from seaweedfs_tpu_torch.telemetry.phases import PhaseTimer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. header and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {nvcc_ver}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    gf_swar.library()
    info = build.build_info["gf_swar"]
    say(f"build gf_swar: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {info['seconds']:.3f} s) -> {os.path.relpath(info['path'], here)}")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["ptxas"])]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                            info["ptxas"]))
    say(f"ptxas: {len(regs)} kernels, registers {min(regs, default=0)}.."
        f"{max(regs, default=0)}, spill stores {spills} bytes")
    forms = sass_doubling(nvcc, info["path"])
    say("SASS gf_swar_kernel<4> doubling forms: " + ", ".join(
        f"{name} x{n}" for name, n in forms.items()))
    check(min(forms.values()) > 0 and len(set(forms.values())) == 1,
          f"the built doubling is no longer {ALU_PER_DOUBLING} ALU + "
          f"{FMA_PER_DOUBLING} FMA-pipe instructions; recount the bound")

    # -- 2. kernel vs plain on the card -------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=dev, generator=gen)

    worst = 0
    differing = 0
    n_cases = 0

    def compare(matrix, data, label):
        nonlocal worst, differing, n_cases
        coeff = gf_swar.coeff_from_reference(matrix)
        got = gf_swar.gf_matmul(coeff, data)
        want = gf_swar.gf_matmul_plain(coeff, data)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        differing += diff
        n_cases += 1
        check(diff == 0, f"gf_swar differs from plain on {label}: "
                         f"{diff} bytes")

    for k, m in ((10, 4), (6, 3), (12, 4), (20, 4)):
        for n in (1, 4095, MIB, MIB + 3):
            compare(gf256.parity_matrix(k, m), rand(k, n),
                    f"parity({k},{m}) N={n}")
    compare(gf256.parity_matrix(10, 4), rand(3, 10, MIB),
            "batched [3,10,1MiB]")
    for lost in ((3,), (0, 13), (0, 5, 11), (0, 5, 11, 13)):
        present = [i for i in range(C.TOTAL_SHARDS) if i not in lost]
        r, _ = gf256.reconstruction_matrix(10, 4, present)
        compare(r, rand(10, 8 * MIB), f"reconstruct lost={lost}")
    say(f"kernel vs plain: {n_cases} cases, {differing} bytes differ, "
        f"max abs err {worst} (tolerance 0: GF(2^8) arithmetic is exact)")

    # -- 3. timing ----------------------------------------------------------
    l2_flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)

    def flush():
        l2_flush.zero_()

    rec_matrix, _ = gf256.reconstruction_matrix(
        10, 4, [i for i in range(14) if i not in (0, 5, 11, 13)]
    )
    shapes = [
        ("encode [10,1MiB]->[4,1MiB]", gf256.parity_matrix(10, 4), MIB),
        ("rebuild [10,8MiB]->[4,8MiB]", rec_matrix, 8 * MIB),
        ("encode [10,64MiB]->[4,64MiB]", gf256.parity_matrix(10, 4),
         64 * MIB),
    ]
    timings = []
    for label, matrix, n in shapes:
        coeff = gf_swar.coeff_from_reference(matrix)
        o, k = matrix.shape
        x = rand(1, k, n)
        out = torch.empty((1, o, n), dtype=torch.uint8, device=dev)
        ms = time_ms(torch, lambda: gf_swar.launch(coeff, x, out),
                     args.reps, flush)
        plain_ms = time_ms(torch, lambda: gf_swar.gf_matmul_plain(coeff, x),
                           max(3, args.reps // 4), flush)
        moved, alu, fma = swar_work(matrix, n)
        bound_ms, bound_by = bound(moved, alu, fma)
        row = {
            "shape": label, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "alu_ops": alu, "fma_ops": fma,
            "input_GBps": k * n / ms / 1e6,
            "bound_share": bound_ms / ms,
        }
        timings.append(row)
        say(f"time {label}: kernel {ms:.4f} ms ({row['input_GBps']:.1f} GB/s "
            f"in), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * row['bound_share']:.1f}% of bound")
    del l2_flush
    say("library call: none (no single PyTorch call computes a GF(2^8) "
        "matrix product)")

    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
    try:
        say(f"workdir {work}: {shutil.disk_usage(work).free / 2**30:.1f} "
            "GiB free")
        rs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev)

        # -- 4. golden fixture ----------------------------------------------
        golden = os.path.join(here, "tests", "golden", "1")
        gbase = os.path.join(work, "golden")
        shutil.copy(golden + ".dat", gbase + ".dat")
        shutil.copy(golden + ".idx", gbase + ".idx")
        encoder.write_ec_files(gbase, rs=rs, **GOLDEN_BLOCKS)
        encoder.write_sorted_file_from_idx(gbase)

        def same(ext):
            with open(gbase + ext, "rb") as a, open(golden + ext, "rb") as b:
                return a.read() == b.read()

        for i in range(C.TOTAL_SHARDS):
            check(same(C.to_ext(i)), f"golden shard {C.to_ext(i)} differs")
        check(same(".ecx"), "golden .ecx differs")
        for sid in (0, 5, 11, 13):
            os.remove(gbase + C.to_ext(sid))
        check(rebuild.rebuild_ec_files(gbase, rs=rs) == [0, 5, 11, 13],
              "golden rebuild ids")
        for i in range(C.TOTAL_SHARDS):
            check(same(C.to_ext(i)), f"golden rebuilt {C.to_ext(i)} differs")
        say("golden fixture: 14 shards, .ecx and rebuild of {0,5,11,13} "
            "byte-identical")

        # -- 5. the main path at full size ----------------------------------
        base = os.path.join(work, "1")
        size = args.volume_mib * MIB
        t0 = time.perf_counter()
        want_ecx = make_volume(base, size, args.seed)
        say(f"volume: {size} bytes from seed {args.seed} in "
            f"{time.perf_counter() - t0:.2f} s")
        n_rows = len(layout.encode_row_plan(size))

        staged0 = rs.staged_bytes
        gf_swar.LAUNCHES.reset()
        pt = PhaseTimer("ec.encode")
        t0 = time.perf_counter()
        encoder.write_ec_files(base, rs=rs, phases=pt)
        encoder.write_sorted_file_from_idx(base)
        enc_s = time.perf_counter() - t0
        enc_launches = gf_swar.LAUNCHES.value
        enc_staged = rs.staged_bytes - staged0
        summary = pt.summary()

        hashes = {
            i: sha256_file(base + C.to_ext(i)) for i in range(C.TOTAL_SHARDS)
        }
        rebuilds = []
        for lost in ((0, 5, 11, 13), (3,)):
            for sid in lost:
                os.remove(base + C.to_ext(sid))
            before = gf_swar.LAUNCHES.value
            staged0 = rs.staged_bytes
            t0 = time.perf_counter()
            got_ids = rebuild.rebuild_ec_files(base, rs=rs)
            rebuilds.append((lost, time.perf_counter() - t0,
                             gf_swar.LAUNCHES.value - before,
                             rs.staged_bytes - staged0))
            check(got_ids == list(lost), f"rebuild ids {got_ids} != {lost}")
            check(rebuilds[-1][3] == 0,
                  f"rebuild {lost} staged {rebuilds[-1][3]} bytes; its "
                  "windows should be read into pinned buffers")
            for sid in lost:
                check(sha256_file(base + C.to_ext(sid)) == hashes[sid],
                      f"rebuilt shard {sid} (lost {lost}) hash differs")
        main_launches = gf_swar.LAUNCHES.value

        check(enc_launches == n_rows,
              f"encode launched {enc_launches} kernels for {n_rows} rows")
        check(enc_staged == 0,
              f"encode staged {enc_staged} bytes; pinned slabs should not be")
        check(main_launches > 0, "main path launched no gf_swar kernel")
        with open(base + ".ecx", "rb") as f:
            check(f.read() == want_ecx, ".ecx differs from the folded .idx")

        # every parity row against the plain version, on the card
        shard_size = os.path.getsize(base + C.to_ext(0))
        check(shard_size == layout.shard_file_size(size),
              f"shard size {shard_size} != {layout.shard_file_size(size)}")
        parity = gf_swar.coeff_from_reference(gf256.parity_matrix(10, 4))
        files = [open(base + C.to_ext(i), "rb") for i in range(14)]
        try:
            window = 8 * MIB
            for off in range(0, shard_size, window):
                n = min(window, shard_size - off)
                rows = np.stack([
                    np.frombuffer(f.read(n), dtype=np.uint8) for f in files
                ])
                on_card = torch.from_numpy(rows).to(dev)
                want = gf_swar.gf_matmul_plain(parity, on_card[:10])
                check(torch.equal(want, on_card[10:]),
                      f"parity rows differ from plain at offset {off}")
        finally:
            for f in files:
                f.close()

        gbps = size / enc_s / 1e9
        say(f"encode {size} bytes: {enc_s:.3f} s = {gbps:.3f} GB/s, "
            f"{enc_launches} launches ({n_rows} rows), {enc_staged} bytes "
            "staged; parity rows match the plain version")
        phases = summary["phases"]
        say("encode phases (busy s): " + " ".join(
            f"{p}={phases[p]['seconds']:.3f}"
            for p in ("read", "stage", "h2d", "codec", "write", "flush")
            if p in phases
        ) + f" wall={summary['wall_seconds']:.3f} "
            f"notes={json.dumps(summary.get('notes', {}))}")
        for lost, secs, launches, staged in rebuilds:
            say(f"rebuild lost={list(lost)}: {secs:.3f} s = "
                f"{size / secs / 1e9:.3f} GB/s (.dat bytes), {launches} "
                f"launches, {staged} bytes staged; hashes match")
        say(f"main path launches: gf_swar={main_launches}")

        # -- 6. device activity over a second, profiled encode --------------
        wall, by_kind, busy = device_activity(
            torch, lambda: encoder.write_ec_files(base, rs=rs)
        )
        for i in range(C.TOTAL_SHARDS):
            check(sha256_file(base + C.to_ext(i)) == hashes[i],
                  f"re-encoded shard {i} differs")
        if busy is None:
            say("device activity: not measured (the trace held no device "
                "events)")
        else:
            say(f"device activity over a profiled encode (wall {wall:.3f} s, "
                "profiler on): " + " ".join(
                    f"{kind}={secs * 1e3:.3f}ms"
                    for kind, secs in by_kind.items()
                ) + f" busy={busy * 1e3:.3f}ms = {100 * busy / wall:.2f}% of "
                f"wall, idle {100 - 100 * busy / wall:.2f}%")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    enc = timings[0]
    say(json.dumps({"kernels": [{
        "name": "gf_swar",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/kernels/csrc/gf_swar.cu",
        "replaces": "seaweedfs_tpu/ops/pallas/gf_kernel.py:146",
        "replaces_fn": "seaweedfs_tpu/ops/pallas/gf_kernel.py:_swar_kernel",
        "launches": main_launches,
        "launches_encode": enc_launches,
        "launches_rebuild": [r[2] for r in rebuilds],
        "max_abs_err": worst,
        "bytes_differing_vs_plain": differing,
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,
        "shape": enc["shape"],
        "timings": timings,
        "encode_GBps": gbps,
        "rebuild_GBps": [size / r[1] / 1e9 for r in rebuilds],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
