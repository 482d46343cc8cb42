#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--volume-mib 1024] [--workdir DIR]
        [--batch-volumes 4] [--batch-volume-mib 256]

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``. Phases, each of which must pass:

1. header: the card's name and power limit, CUDA and nvcc versions, and
   the build of every kernel from the sources in the checkout (one
   ``nvcc`` per source, all started together) and of the native host
   codec (``g++``), with ptxas's registers and
   spills (none allowed in gf_swar and gf_swar_u8) and SASS checks: the
   doubling's instruction forms, and the XOR LOP3s a word of the
   compile-time RS(10,4) form of gf_swar and of gf_swar_u8, no more than
   the matrix's set bits; gf_swar's decides how the bound counts XORs
   (for the parity, the lower of that count and the pairs');
   gf_bitplane's registers, spills (none allowed at MT <= 2, every RS
   shape) and blocks an SM per instantiation, its shipped kernel's VOTE
   (none: the pack gathers in the lane) and SHFL counts, and its ALU and
   FMA-pipe instructions a chunk, static, in three scopes: the design's
   own unpack and pack (its floor; fails if a form matches nothing), the
   whole-span loop, and the whole function;
2. every kernel against its plain PyTorch version on the card, byte for
   byte, at the shapes the main paths give it: gf_swar, and gf_swar in
   each coefficient form at each column width W on word counts with
   tails; gf_repack's u32
   words and gf_unpack; gf_swar_u8 on ragged widths, a strided row view
   and a batch, and in each coefficient form at each W on word counts no
   W divides, partial last words, strided rows, batches and rows one
   byte past an aligned address (the byte path); gf_bitplane, gf_vpu,
   gf_fused_u8 (tiles of 8, 16 and 32 KiB and a scalar tile), gf_swar's
   batch-fastest launch and gf_swar_fusedv on four RS shapes and four
   loss patterns; gf_bitplane also at the edges of its spans (widths one
   short of and one past a whole number of spans, few and more than the
   grid's warps take at once, rows one byte past an aligned address or
   with an odd stride, aligned strided rows, a batch) for the parity, the
   {0,5,11,13} rebuild, o = 5 and 6 (padded m-tiles), and k = 64;
3. kernel timing with CUDA events (L2 flushed between launches) beside
   the plain version's time, the card's bound for the same work and,
   where one PyTorch call computes the same function, that call's time;
   gf_swar and gf_swar_u8 at the form and W their wrappers choose, then
   in each other form and W; gf_bitplane's bound (bytes once, the
   unpadded int8 product) beside the count it had before, which added
   the first design's unpack and pack;
4. the vendored golden fixture (tests/golden/1.*): encode, ``.ecx`` and
   a 4-shard rebuild byte-identical to the golden shards, twice: with the
   codec's floor at 0 (every dispatch on the kernel) and at its default
   (the encode's 4 KiB chunks on the native host codec); each run's
   kernel launches and host dispatches equal what the codec's routing
   gives its widths (so do phases 5 and 9's);
5. the codec path at full size: a ``.dat`` volume made from ``--seed``
   (1 GiB by default) through ``write_ec_files`` →
   ``write_sorted_file_from_idx`` → ``rebuild_ec_files`` of shards
   {0, 5, 11, 13} and of {3}, every parity row checked against the plain
   version on the card and every rebuilt shard against its original
   hash; launch counts read around the run prove it went through the
   kernels, the encode's in gf_swar's compile-time RS(10,4) form and the
   rebuilds' in its run-time form;
6. a second encode of the volume under torch.profiler: device time by
   kind (kernel, H2D, D2H) and the device's busy and idle share;
7. the device-resident path at full size: a [10, 64 MiB] slab made on the
   card through ``gf_matmul_fused`` with ``method=None`` (the autotuner
   measures live into a temporary cache and prints each candidate), then
   through each method for parity and the {0,5,11,13} reconstruction and
   through the device-u32 route; the RS(6,3)/(12,4)/(20,4) sweep at
   32 MiB a shard; an 8-volume batch [8, 10, 64 MiB], as a batch and
   lane-packed as [10, 8·64 MiB]; the vpu route on a host array. Every
   output is checked against the plain versions on the card, GB/s is
   printed per route, and launch counts read around the phase prove each
   of the path's six kernels ran, and that gf_swar_u8 took the
   compile-time form for every RS(10,4) parity launch and the run-time
   form for every other matrix;
8. the three sweeps of tools/exp_dev8.py, tools/exp_dev8b.py and
   tools/exp_batched.py at their full default sizes, through
   seaweedfs_tpu_torch/tools: every row byte-exact against the plain
   version and timed; launch counts read around the phase prove that
   gf_vpu, gf_repack, gf_fused_u8, gf_swar_fusedv and the batch-fastest
   launch ran;
9. the multi-volume encode: ``write_ec_files_batch`` of
   ``--batch-volumes`` volumes of ``--batch-volume-mib`` made from
   ``--seed`` plus one volume of odd size (a second group), one parity
   launch per lane-packed chunk, all in the compile-time RS(10,4) form,
   every shard file hashing equal to ``write_ec_files`` of the same
   volume; GB/s and the phase split;
10. the EC read path and ``ec.decode``: a volume of version-3 needles
    made from ``--seed`` (``--volume-mib``; sizes log-uniform from 1 KiB
    to 4 MiB, names and mime types on a seeded share, 1 % overwritten and
    1 % deleted), encoded; with shards {0, 5, 11, 13} and then {3} lost,
    ``EcVolume.read_needle`` of a seeded sample of up to 4,096 live
    needles and every other one with an interval on a lost shard (up to
    4,096), each byte-exact against the generator: the intervals read
    directly and reconstructed on the native host route and on the kernel
    route (both must be taken, and gf_swar's launches must equal the
    kernel-route intervals), needles/s, p50 and p99 latency; then 64
    deletes through the ``.ecj``, ``rebuild_ec_files`` of {0, 5, 11, 13},
    ``find_dat_file_size``, ``write_dat_file`` and
    ``write_idx_file_from_ec_index``: the ``.dat`` must hash equal to the
    original's live extent and the ``.idx`` equal the ``.ecx`` plus one
    tombstone a delete; decode GB/s. Last, outside the path's count, the
    crossover: one lost data shard rebuilt from ten for windows of 1 KiB
    to 4 MiB on the native codec and on the kernel (wall time, H2D and
    D2H included, median of ``--reps``), printed with the codec's floor;
11. routing and observability, on the default link-aware codec: a fresh
    link state's probe (H2D and D2H GB/s, round trip; none may be 0 or
    past 100 GB/s), printed beside the card; phase 5's volume encoded
    twice, each encode's route split read from
    ``seaweedfs_codec_route_total`` and held to gf_swar's launches and
    the native host dispatches (together the encode's dispatches; at
    least one above-floor dispatch on the card), its GB/s, device share
    and EWMAs, its shards hashing equal to phase 5's; the first encode
    under a root span with a PhaseTimer whose ``finish()`` must record one
    span a phase and one ``seaweedfs_phase_seconds`` observation a phase
    (its waterfall printed), every codec dispatch a span under the root;
    the device ledger's row ``0`` (dispatches and H2D bytes equal to the
    device-routed ones) and staging lane (one chunk a dispatch);
    ``choose_pipeline(30 GB)`` before and after the EWMAs are warm; an
    encode under torch.profiler with the profiler's annotation on (one
    ``codec.encode(cuda,4x10)`` range a device-routed dispatch); and the
    ``codec.dispatch`` fault armed once, which must fail
    ``write_ec_files`` with ``FaultInjected`` and count once, before an
    encode that must be byte-exact again; then shards {0, 5, 11, 13}
    rebuilt on the same codec, its route split held to the launches and
    host dispatches, the shards hashing equal to phase 5's. Recording's
    cost a dispatch is measured last, on scratch copies of the records.

Phases 4, 5 (with 6), 9 and 10 pin their codecs to
``link_aware=False`` (the size floor alone decides their routes), so
their expected launches and host dispatches follow from the widths;
phase 11 runs the link-aware default.

It prints ``read_decode`` and ``routing`` JSON lines, one JSON line
describing every kernel, then, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import itertools
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
# Dense int8 tensor-core peak of one H100 SXM (NVIDIA data sheet).
INT8_TENSOR_OPS_PER_S = 1.979e15
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
# The instructions of one doubling of a byte alone in a 32-bit lane, as
# gf_vpu's kernel does it: the SWAR forms without the per-byte mask.
VPU_DOUBLING_FORMS = {
    "SHF.R x>>7": ("alu", r"SHF\.R\.U32\.HI R\d+, RZ, 0x7, R\d+"),
    "LOP3 (x<<1&0xfe)^t": ("alu", r"LOP3\.LUT R\d+, R\d+, 0xfe, R\d+, 0x78"),
    "IMAD.SHL x<<1": ("fma", r"IMAD\.SHL\.U32 R\d+, R\d+, 0x2, RZ"),
    "IMAD *0x1d": ("fma", r"IMAD R\d+, R\d+, 0x1d, RZ"),
}
VPU_ALU_PER_DOUBLING = sum(p == "alu" for p, _ in VPU_DOUBLING_FORMS.values())
VPU_FMA_PER_DOUBLING = sum(p == "fma" for p, _ in VPU_DOUBLING_FORMS.values())

# gf_bitplane's instantiation for o <= 4, k <= 16 (the RS(10,4) launches):
# <MT = 2 m-tiles, 4 K slices unrolled>
BITPLANE_SYMBOL = "gf_bitplane_kernelILi2ELi4EE"

MIB = 1 << 20
GOLDEN_BLOCKS = dict(large_block_size=10_000, small_block_size=100,
                     batch_bytes=4096)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def sass_body(nvcc: str, lib_path: str, symbol: str) -> str:
    """The built SASS of the kernel whose mangled name contains
    ``symbol``."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    return sass.split(symbol, 1)[1].split("Function :", 1)[0]


def sass_doubling(nvcc: str, lib_path: str, symbol: str,
                  forms=DOUBLING_FORMS) -> dict[str, int]:
    """How often each instruction form of ``forms`` appears in the built
    SASS of a kernel's o = 4 instantiation, the one encode, rebuild and
    the RS(10,4) slab launch."""
    body = sass_body(nvcc, lib_path, symbol)
    return {name: len(re.findall(pattern, body))
            for name, (_, pattern) in forms.items()}


# LOP3 truth tables that are an XOR of two or three inputs, or its
# complement
XOR_LUTS = {0x96, 0x69, 0x3C, 0xC3, 0x5A, 0xA5, 0x66, 0x99}


def sass_xor_lop3(nvcc: str, lib_path: str, symbol: str) -> int:
    """Static count of the LOP3s of a kernel's SASS whose truth table is
    an XOR (:data:`XOR_LUTS`)."""
    luts = re.findall(r"LOP3\.LUT (?:P\w+, )?\w+, [^,;]+, [^,;]+, [^,;]+, "
                      r"(0x[0-9a-f]+)", sass_body(nvcc, lib_path, symbol))
    return sum(int(lut, 16) in XOR_LUTS for lut in luts)


def sass_opcodes(nvcc: str, lib_path: str, symbol: str) -> dict[str, int]:
    """Static count of each opcode (without modifiers) in a kernel's SASS."""
    ops: dict[str, int] = {}
    for m in re.finditer(
            r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
            sass_body(nvcc, lib_path, symbol)):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def ptxas_entries(report: str, kernel: str):
    """[(name, template int arguments, registers, spill store bytes)] of
    each entry function whose name matches the regular expression
    ``kernel`` in a ``ptxas -v`` report."""
    entries = []
    for part in report.split("Compiling entry function '")[1:]:
        symbol = part.split("'", 1)[0]
        m = re.search(rf"({kernel})I((?:L[ib]\d+E)+)E", symbol)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(2))]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        entries.append((m.group(1), args, int(regs.group(1)) if regs else 0,
                        int(spill.group(1)) if spill else 0))
    return entries


def xor_ops(matrix: np.ndarray, folded: bool) -> int:
    """ALU instructions of the XORs of one u32 word: one a set coefficient
    bit, or, ``folded``, the least a three-input LOP3 allows: an output
    of t terms starts from its first and folds two more into each LOP3,
    ceil((t - 1) / 2)."""
    terms = np.unpackbits(matrix, axis=1).sum(axis=1)
    if not folded:
        return int(terms.sum())
    return int(sum(t // 2 for t in terms))  # ceil((t - 1) / 2) for t >= 0


def swar_work(matrix: np.ndarray, n_bytes: int, batch: int = 1, *,
              folded: bool, xors: float | None = None):
    """(bytes moved, ALU-pipe ops, FMA-pipe ops) of one kernel call:
    each input byte read once and each output byte written once; per u32
    word, one doubling per coefficient bit past the first of each input
    row and ``xors`` XOR instructions, by default those of
    :func:`xor_ops`. ``folded`` counts them as the compile-time
    instantiation's SASS shows ptxas issuing them (phase 1 checks it);
    False, one LOP3 per set bit, as the bound was first counted."""
    o, k = matrix.shape
    tops = [int(c).bit_length() for c in np.bitwise_or.reduce(matrix, axis=0)]
    xtimes = sum(max(0, t - 1) for t in tops)
    words = batch * (-(-n_bytes // 4))
    moved = batch * (k + o) * n_bytes
    if xors is None:
        xors = xor_ops(matrix, folded)
    return (moved, words * (ALU_PER_DOUBLING * xtimes + xors),
            words * FMA_PER_DOUBLING * xtimes)


def vpu_work(matrix: np.ndarray, n_bytes: int, batch: int = 1):
    """(bytes moved, ALU-pipe ops, FMA-pipe ops) of one gf_vpu call: the
    SWAR count per byte instead of per u32 word, each doubling the
    VPU_DOUBLING_FORMS."""
    o, k = matrix.shape
    tops = [int(c).bit_length() for c in np.bitwise_or.reduce(matrix, axis=0)]
    xtimes = sum(max(0, t - 1) for t in tops)
    xors = int(np.unpackbits(matrix).sum())
    cols = batch * n_bytes
    return (batch * (k + o) * n_bytes,
            cols * (VPU_ALU_PER_DOUBLING * xtimes + xors),
            cols * VPU_FMA_PER_DOUBLING * xtimes)


def bitplane_work(o: int, k: int, n_bytes: int, batch: int = 1):
    """(bytes moved, ALU-pipe ops, FMA-pipe ops, int8 tensor ops) of the
    function one gf_bitplane call computes: each byte read once and written
    once, and the tensor-core operations of the unpadded bit-plane product,
    2 * o*8 * k*8 a column. How the kernel unpacks and packs the bits is its
    design, not the function: :func:`bitplane_counts` counts that."""
    cols = batch * n_bytes
    return (batch * (k + o) * n_bytes, 0, 0, 2 * (o * 8) * (k * 8) * cols)


def bitplane_work_before(o: int, k: int, n_bytes: int, batch: int = 1):
    """The count the bound took before it counted the function's work: the
    first design's unpack (every input byte into two 0/1 nibble spreads:
    6 ALU and 2 FMA operations a byte) and pack (17 ALU operations an
    output byte: mask, ballot gather and merge) added to the bytes and the
    tensor operations. Printed beside the bound for comparison."""
    cols = batch * n_bytes
    return (batch * (k + o) * n_bytes, 6 * k * cols + 17 * o * cols,
            2 * k * cols, 2 * (o * 8) * (k * 8) * cols)


# The instruction forms of gf_bitplane's own arithmetic, as the built
# kernel issues them (phase 1 counts them in the SASS): the unpack, per K
# slice and n-tile, broadcasts byte t of the lane's word and masks it
# twice; the pack gathers byte 0 of four sums (three byte permutes),
# shifts each gather into place, ORs them and trades half with one
# shuffle. All of it is ALU-pipe work but the shuffle; none is IMAD.
BITPLANE_FORMS = {
    "PRMT byte t x4": ("unpack", r"PRMT R\d+, R\d+(?:\.reuse)?, "
                                 r"(?:RZ|0x1111|0x2222|0x3333), RZ"),
    "LOP3 &0x8040201": ("unpack", r"LOP3\.LUT R\d+, R\d+(?:\.reuse)?, "
                                  r"0x8040201, RZ, 0xc0"),
    "LOP3 &0x80402010": ("unpack", r"LOP3\.LUT R\d+, R\d+(?:\.reuse)?, "
                                   r"0x80402010, RZ, 0xc0"),
    "PRMT 0x40": ("pack", r"PRMT R\d+, R\d+(?:\.reuse)?, 0x40, R\d+"),
    "PRMT 0x5410": ("pack", r"PRMT R\d+, R\d+(?:\.reuse)?, 0x5410, R\d+"),
    "SHF.R >>4..7": ("pack", r"SHF\.R\.U32\.HI R\d+, RZ, 0x[4-7], R\d+"),
    "LOP3 OR": ("pack", r"LOP3\.LUT R\d+, R\d+, R\d+, R\d+, 0xfe"),
}


# Opcodes of the integer ALU pipe and of the FMA pipe, as the counts of
# gf_bitplane's SASS class them
ALU_OPCODES = {"LOP3", "PRMT", "SHF", "ISETP", "IADD3", "LEA", "SEL", "IABS",
               "IMNMX", "PLOP3", "BMSK", "POPC", "FLO"}
FMA_OPCODES = {"IMAD"}


def bitplane_counts(nvcc: str, lib_path: str, symbol: str, m_tiles: int,
                    ks_max: int, k: int):
    """(count of each form of :data:`BITPLANE_FORMS`, {scope: (ALU, FMA)
    instructions a 32-column chunk}) of one built instantiation <m_tiles,
    ks_max>, static, in three scopes:

    - ``forms``: the design's own unpack and pack, the forms of
      :data:`BITPLANE_FORMS` over the chunk bodies the SASS holds (its
      IMMAs over the m_tiles * 4 * ks_max of one body), the unpack's scaled
      to the ceil(k/4) of its ks_max K slices that run: what the design
      cannot do with less;
    - ``loop``: every instruction of the whole-span loop (the predicated
      backward branch whose range holds the most IMMAs) over the chunks it
      holds: the hot path, address arithmetic, compares and loop control
      included, and K slices that k skips;
    - ``function``: every instruction of the instantiation over its chunk
      bodies, the masked byte path and the set-up included.

    Fails if a form of :data:`BITPLANE_FORMS` no longer matches (a
    compiler that spells it otherwise would read as a lower count)."""
    body = sass_body(nvcc, lib_path, symbol)
    forms = {name: len(re.findall(pattern, body))
             for name, (_, pattern) in BITPLANE_FORMS.items()}
    check(min(forms.values()) > 0,
          "a form of BITPLANE_FORMS matches nothing in gf_bitplane's SASS: "
          + ", ".join(name for name, n in forms.items() if n == 0))
    ins = [(int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4))
           for m in re.finditer(r"/\*([0-9a-f]{4,5})\*/\s+(@!?U?P\w+\s+)?"
                                r"([A-Z][A-Z0-9]*)([^;]*);", body)]
    per_body = m_tiles * 4 * ks_max

    def pipes(ops):
        return (sum(op in ALU_OPCODES for op in ops),
                sum(op in FMA_OPCODES for op in ops))

    loops = []
    for addr, predicated, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if predicated and target and int(target.group(1), 16) < addr:
            ops = [o for a, _, o, _ in ins
                   if int(target.group(1), 16) <= a <= addr]
            loops.append((ops.count("IMMA"), -len(ops), ops))
    imma, _, loop = max(loops, default=(0, 0, []))
    check(imma > 0 and imma % per_body == 0,
          f"gf_bitplane's whole-span loop holds {imma} IMMAs, not whole "
          f"chunk bodies of {per_body}")
    copies = [o for _, _, o, _ in ins].count("IMMA") / per_body
    ks_n = -(-k // 4)
    counts = {
        "forms": (sum(n * (ks_n / ks_max if BITPLANE_FORMS[name][0] ==
                           "unpack" else 1)
                      for name, n in forms.items()) / copies, 0.0),
        "loop": tuple(n / (imma / per_body) for n in pipes(loop)),
        "function": tuple(n / copies
                          for n in pipes([o for _, _, o, _ in ins])),
    }
    return forms, counts


def chunk_ms(alu: float, fma: float, n_bytes: int, batch: int = 1) -> float:
    """ms of ``alu`` and ``fma`` instructions a 32-column chunk over every
    chunk of a call, each pipe at its peak: a count's time, not the
    bound."""
    return 1e3 * 32 * batch * -(-n_bytes // 32) * max(alu, fma) / \
        INT_PIPE_OPS_PER_S


def bound(moved: int, alu: int, fma: int,
          tensor: int = 0) -> tuple[float, str]:
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(max(alu, fma) / INT_PIPE_OPS_PER_S,
                tensor / INT8_TENSOR_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def encode_widths(dat_size: int, volumes: int = 1, **blocks) -> list[int]:
    """The shard width of each codec dispatch of ``_encode_lockstep``
    over ``volumes`` volumes of ``dat_size`` bytes: one lane-packed
    chunk of ``volumes`` x n columns for each chunk of the row plan.
    ``blocks`` takes ``large_block_size``, ``small_block_size`` and
    ``batch_bytes`` as the encoder does."""
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        constants as C,
        encoder,
        layout,
    )

    large = blocks.get("large_block_size", C.LARGE_BLOCK_SIZE)
    small = blocks.get("small_block_size", C.SMALL_BLOCK_SIZE)
    batch, _ = encoder.choose_pipeline(dat_size, C.DATA_SHARDS,
                                       blocks.get("batch_bytes"),
                                       volumes=volumes)
    return [volumes * min(batch, bs - co)
            for _, bs in layout.encode_row_plan(dat_size, large, small)
            for co in range(0, bs, batch)]


def rebuild_widths(shard_size: int) -> list[int]:
    """The shard width of each codec dispatch of ``rebuild_ec_files``:
    one a window."""
    from seaweedfs_tpu_torch.storage.erasure_coding import rebuild

    window = rebuild.DEFAULT_WINDOW_BYTES
    return [min(window, shard_size - off)
            for off in range(0, shard_size, window)]


def routes(widths: list[int], floor: int) -> tuple[int, int]:
    """(kernel launches, native host dispatches) that a ``cuda`` codec of
    this floor makes for dispatches of these shard widths."""
    from seaweedfs_tpu_torch.ops.codec import choose_route

    kernel = sum(choose_route("cuda", w, floor) == "cuda" for w in widths)
    return kernel, len(widths) - kernel


MIMES = (b"application/octet-stream", b"image/jpeg", b"image/png",
         b"text/plain; charset=utf-8", b"video/mp4")


def needle_payload(seed: int, i: int, n: int) -> bytes:
    """The data of the ``i``-th record ``make_needle_volume`` wrote."""
    return np.random.default_rng([seed, i]).bytes(n)


def make_needle_volume(base: str, size: int, seed: int,
                       min_bytes: int = 1024, max_bytes: int = 4 * MIB):
    """Write ``<base>.dat``, a version-3 volume of at most ``size``
    bytes, and its ``<base>.idx`` from ``seed``, as a volume server
    would: a superblock, then needle records, each one indexed. Data
    sizes are log-uniform in [min_bytes, max_bytes] (1 KiB, the
    ``weed benchmark`` default object, to 4 MiB, past the 1 MiB small
    block); half the needles carry a name and a third a mime type. Of
    the records after the first, 1 % overwrite a live needle with new
    data and 1 % delete one (a tombstone record, and an ``.idx`` entry
    of size -1). Writing stops before the record that would pass
    ``size``.

    Returns ``(live, deleted)``: ``live`` maps each live needle id to
    ``(i, data bytes, name, mime)``, its data being
    ``needle_payload(seed, i, data bytes)``; ``deleted`` lists the ids
    deleted."""
    from seaweedfs_tpu_torch.storage import idx, needle, super_block
    from seaweedfs_tpu_torch.storage import types as t

    rng = np.random.default_rng(seed)
    live: dict[int, tuple[int, int, bytes, bytes]] = {}
    deleted: list[int] = []
    used: set[int] = set()
    log: list[tuple[int, int, int]] = []  # .idx entries: id, offset, size
    with open(base + ".dat", "wb") as f:
        off = f.write(super_block.SuperBlock(version=t.VERSION3).to_bytes())
        for i in itertools.count():
            r = rng.random()
            if live and r < 0.01:  # delete a live needle
                key = int(rng.choice(sorted(live)))
                n = needle.Needle(id=key)
                n.append_at_ns = 1_700_000_000_000_000_000 + i
                rec = n.to_bytes(t.VERSION3)
                if off + len(rec) > size:
                    break
                log.append((key, off, t.TOMBSTONE_FILE_SIZE))
                del live[key]
                deleted.append(key)
                off += f.write(rec)
                continue
            if live and r < 0.02:  # overwrite a live needle
                key = int(rng.choice(sorted(live)))
            else:
                key = int(rng.integers(1, 1 << 40))
                while key in used:
                    key = int(rng.integers(1, 1 << 40))
            n_bytes = int(np.exp(rng.uniform(np.log(min_bytes),
                                             np.log(max_bytes))))
            n = needle.Needle(cookie=int(rng.integers(0, 1 << 32)), id=key,
                              data=needle_payload(seed, i, n_bytes))
            if rng.random() < 0.5:
                n.set_name(f"obj-{i:07d}-{int(rng.integers(1 << 32)):08x}"
                           ".bin".encode())
            if rng.random() < 1 / 3:
                n.set_mime(MIMES[int(rng.integers(len(MIMES)))])
            n.append_at_ns = 1_700_000_000_000_000_000 + i
            rec = n.to_bytes(t.VERSION3)
            if off + len(rec) > size:
                break
            used.add(key)
            log.append((key, off, n.size))
            live[key] = (i, n_bytes, n.name, n.mime)
            off += f.write(rec)
    entries = np.zeros(len(log), dtype=idx.ENTRY_DTYPE)
    if log:
        entries["key"], entries["offset"], entries["size"] = zip(*log)
    with open(base + ".idx", "wb") as f:
        f.write(idx.pack_entries(entries))
    return live, deleted


def percentile_ms(seconds: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def degraded_reads(ev, chosen, lost, live, seed, floor):
    """Read ``chosen`` needles of the ``EcVolume`` ``ev`` (shards
    ``lost`` missing) and check each against what the generator wrote.
    Returns the intervals read directly and reconstructed on each route,
    the gf_swar launches and host dispatches around the reads, and each
    read's latency in seconds."""
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.ops.kernels import gf_swar
    from seaweedfs_tpu_torch.storage.erasure_coding import layout

    direct, widths, degraded = 0, [], set()
    for key in chosen:
        for iv in ev.locate_needle(key)[2]:
            if layout.to_shard_id_and_offset(iv)[0] in lost:
                widths.append(iv.size)
                degraded.add(key)
            else:
                direct += 1
    kernel, host = routes(widths, floor)
    # seconds inside the reconstructions, and within them in the codec
    # buffer's allocation and in the codec: wrappers on this volume's
    # own methods, removed after the reads
    spent = {"reconstruct": 0.0, "buffer": 0.0, "codec": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    ev._reconstruct_interval = timed("reconstruct", ev._reconstruct_interval)
    ev.rs.host_zeros = timed("buffer", ev.rs.host_zeros)
    ev.rs.reconstruct = timed("codec", ev.rs.reconstruct)
    launches0 = gf_swar.LAUNCHES.value
    host0 = codec_mod.HOST_DISPATCHES.value
    latency, rebuilt_latency, whole_latency = [], [], []
    try:
        for key in chosen:
            t0 = time.perf_counter()
            n = ev.read_needle(key)
            latency.append(time.perf_counter() - t0)
            (rebuilt_latency if key in degraded else whole_latency).append(
                latency[-1])
            i, n_bytes, name, mime = live[key]
            check(n.data == needle_payload(seed, i, n_bytes),
                  f"needle {key:x} (lost {lost}): data differs")
            check(n.name == name and n.mime == mime,
                  f"needle {key:x} (lost {lost}): name or mime differs")
    finally:
        del ev._reconstruct_interval, ev.rs.host_zeros, ev.rs.reconstruct
    return {
        "lost": list(lost), "needles": len(chosen),
        "intervals_direct": direct, "intervals_host": host,
        "intervals_kernel": kernel,
        "gf_swar_launches": gf_swar.LAUNCHES.value - launches0,
        "host_dispatches": codec_mod.HOST_DISPATCHES.value - host0,
        "needles_per_s": len(chosen) / sum(latency),
        "p50_ms": percentile_ms(latency, 50),
        "p99_ms": percentile_ms(latency, 99),
        # the reads that reconstructed an interval, and the others
        "needles_reconstructed": len(rebuilt_latency),
        "reconstructed_p50_ms": percentile_ms(rebuilt_latency, 50),
        "reconstructed_p99_ms": percentile_ms(rebuilt_latency, 99),
        "direct_p50_ms": percentile_ms(whole_latency, 50),
        "direct_p99_ms": percentile_ms(whole_latency, 99),
        "read_seconds": sum(latency),
        # of which: reconstructions, and within them the survivor reads
        # (what is left), the buffer and the codec
        "reconstruct_seconds": spent["reconstruct"],
        "survivor_read_seconds": (spent["reconstruct"] - spent["buffer"]
                                  - spent["codec"]),
        "buffer_seconds": spent["buffer"],
        "codec_seconds": spent["codec"],
    }


def crossover(torch, dev, seed, agree, reps):
    """Reconstruct lost data shard 0 from shards 1-10 for windows of n
    bytes on the native host route and on the kernel route (wall time of
    ``RSCodec.reconstruct``, the kernel's H2D and D2H included), the
    median of ``reps`` calls each after a warm one, taken in turns. Each
    window's two outputs must agree with each other and with the plain
    version on the card. Returns the rows and the first n from which the
    kernel route stays faster (None if it never is)."""
    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.ops.kernels import gf_swar

    host_rs = RSCodec(10, 4, device=dev, device_min_bytes=1 << 62)
    card_rs = RSCodec(10, 4, device=dev, device_min_bytes=0,
                      link_aware=False)
    present = list(range(1, 11))
    r, missing = gf256.reconstruction_matrix(10, 4, present)
    coeff = gf_swar.coeff_from_reference(r[[missing.index(0)]])
    rng = np.random.default_rng(seed)
    rows = []
    for n in (1024, 4096, 16384, 65536, 131072, 262144, MIB, 4 * MIB):
        buf = card_rs.host_zeros((10, n))
        buf[:] = rng.integers(0, 256, (10, n), dtype=np.uint8)
        shards = {sid: buf[j] for j, sid in enumerate(present)}
        outs = {}
        times = {"native": [], "kernel": []}
        for rep in range(reps + 1):
            for route, rs in (("native", host_rs), ("kernel", card_rs)):
                t0 = time.perf_counter()
                got = rs.reconstruct(shards, wanted=[0])[0]
                if rep:
                    times[route].append(time.perf_counter() - t0)
                outs[route] = got
        check(np.array_equal(outs["native"], outs["kernel"]),
              f"crossover n={n}: native and kernel routes differ")
        on_card = torch.from_numpy(buf).to(dev)
        agree("gf_swar", torch.from_numpy(outs["kernel"]).to(dev)[None],
              gf_swar.gf_matmul_plain(coeff, on_card),
              f"reconstruct 1 of [10,{n}] (read path)")
        rows.append({
            "n": n,
            "native_ms": statistics.median(times["native"]) * 1e3,
            "kernel_ms": statistics.median(times["kernel"]) * 1e3,
        })
    faster = [row["kernel_ms"] < row["native_ms"] for row in rows]
    cross = next((rows[i]["n"] for i in range(len(rows))
                  if all(faster[i:])), None)
    return rows, cross


def phase_read_decode(args, torch, dev, agree, reset_counts, counters):
    """Phase 10: the EC read path and ec.decode on a needle volume.
    Returns the phase's row and the launch counts of its path."""
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.storage.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        constants as C,
        decoder,
        encoder,
        layout,
        rebuild,
    )

    work = tempfile.mkdtemp(prefix="chip_smoke-read-", dir=args.workdir)
    try:
        base = os.path.join(work, "1")
        t0 = time.perf_counter()
        live, deleted = make_needle_volume(base, args.volume_mib * MIB,
                                           args.seed)
        dat_size = os.path.getsize(base + ".dat")
        gen_s = time.perf_counter() - t0
        # pinned to the size floor, as phases 4, 5 and 9: the expected
        # routes below follow from the widths alone
        rs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev,
                     link_aware=False)
        floor = rs.device_min_bytes
        t0 = time.perf_counter()
        encoder.write_ec_files(base, rs=rs)
        encoder.write_sorted_file_from_idx(base)
        say(f"needle volume: {dat_size} bytes, {len(live)} live needles "
            f"and {len(deleted)} deleted, from seed {args.seed} in "
            f"{gen_s:.2f} s; encoded in {time.perf_counter() - t0:.2f} s")
        keys = sorted(live)
        rng = np.random.default_rng(args.seed)
        sample = [keys[j] for j in sorted(rng.choice(
            len(keys), min(4096, len(keys)), replace=False))]
        in_sample = set(sample)

        reset_counts()
        reads = []
        for lost in ((0, 5, 11, 13), (3,)):
            for sid in lost:
                os.rename(base + C.to_ext(sid), base + C.to_ext(sid) + ".x")
            ev = EcVolume(base, 1, rs=rs)
            try:
                check(ev.shard_ids == [i for i in range(C.TOTAL_SHARDS)
                                       if i not in lost],
                      f"EcVolume opened shards {ev.shard_ids}")
                # the sample, and every live needle with an interval on a
                # lost shard, up to 4,096 more
                extra = [key for key in keys if key not in in_sample and any(
                    layout.to_shard_id_and_offset(iv)[0] in lost
                    for iv in ev.locate_needle(key)[2])][:4096]
                row = degraded_reads(ev, sample + extra, lost, live,
                                     args.seed, ev.rs.device_min_bytes)
                for key in deleted[:8]:
                    try:
                        ev.read_needle(key)
                    except KeyError:
                        continue
                    raise AssertionError(f"deleted needle {key:x} read")
            finally:
                ev.close()
            for sid in lost:
                os.rename(base + C.to_ext(sid) + ".x", base + C.to_ext(sid))
            reads.append(row)
            check(row["intervals_host"] > 0 and row["intervals_kernel"] > 0,
                  f"reads with {lost} lost reconstructed {row} : both "
                  "routes must be taken")
            check(row["gf_swar_launches"] == row["intervals_kernel"],
                  f"reads with {lost} lost: {row['gf_swar_launches']} "
                  f"gf_swar launches for {row['intervals_kernel']} "
                  "kernel-route intervals")
            check(row["host_dispatches"] == row["intervals_host"],
                  f"reads with {lost} lost: {row['host_dispatches']} host "
                  f"dispatches for {row['intervals_host']} host-route "
                  "intervals")
            say(f"degraded reads, lost {list(lost)}: {row['needles']} "
                f"needles byte-exact; intervals {row['intervals_direct']} "
                f"direct, {row['intervals_host']} reconstructed on the host "
                f"route, {row['intervals_kernel']} on the kernel route "
                f"({row['gf_swar_launches']} gf_swar launches); "
                f"{row['needles_per_s']:.1f} needles/s, p50 "
                f"{row['p50_ms']:.4f} ms, p99 {row['p99_ms']:.4f} ms; the "
                f"{row['needles_reconstructed']} needles that reconstructed "
                f"p50 {row['reconstructed_p50_ms']:.4f} ms, p99 "
                f"{row['reconstructed_p99_ms']:.4f} ms, the others p50 "
                f"{row['direct_p50_ms']:.4f} ms, p99 "
                f"{row['direct_p99_ms']:.4f} ms")
            say(f"degraded reads, lost {list(lost)}, where the time goes: "
                f"{row['read_seconds']:.4f} s reading, of which "
                f"{row['reconstruct_seconds']:.4f} s reconstructing: "
                f"survivor reads {row['survivor_read_seconds']:.4f} s, "
                f"codec buffer {row['buffer_seconds']:.4f} s, codec "
                f"{row['codec_seconds']:.4f} s")

        # ec.decode: journal deletes, make the data shards whole, then
        # shards -> .dat and .ecx + .ecj -> .idx
        ev = EcVolume(base, 1, rs=rs)
        try:
            doomed = [int(k) for k in rng.choice(keys, min(64, len(keys)),
                                                   replace=False)]
            for key in doomed:
                ev.delete_needle(key)
            try:
                ev.read_needle(doomed[0])
                raise AssertionError("a journalled delete still reads")
            except KeyError:
                pass
        finally:
            ev.close()
        lost = (0, 5, 11, 13)
        want_shards = {sid: sha256_file(base + C.to_ext(sid)) for sid in lost}
        for sid in lost:
            os.remove(base + C.to_ext(sid))
        launches0 = counters["gf_swar"].value
        t0 = time.perf_counter()
        check(rebuild.rebuild_ec_files(base, rs=rs) == list(lost),
              "decode rebuild ids")
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = counters["gf_swar"].value - launches0
        for sid in lost:
            check(sha256_file(base + C.to_ext(sid)) == want_shards[sid],
                  f"decode: rebuilt shard {sid} differs")
        os.rename(base + ".dat", base + ".orig")
        t0 = time.perf_counter()
        extent = decoder.find_dat_file_size(base)
        decoder.write_dat_file(base, extent)
        decoder.write_idx_file_from_ec_index(base)
        decode_s = time.perf_counter() - t0
        with open(base + ".orig", "rb") as f:
            h = hashlib.sha256()
            left = extent
            while left:
                buf = f.read(min(left, 16 * MIB))
                check(len(buf) > 0,
                      "original .dat shorter than its live extent")
                h.update(buf)
                left -= len(buf)
        check(os.path.getsize(base + ".dat") == extent
              and sha256_file(base + ".dat") == h.hexdigest(),
              "decoded .dat differs from the original's live extent")
        with open(base + ".ecx", "rb") as f:
            want_idx = f.read() + b"".join(
                struct.pack(">QIi", key, 0, -1) for key in doomed)
        with open(base + ".idx", "rb") as f:
            check(f.read() == want_idx,
                  ".idx differs from the .ecx and one tombstone a journalled "
                  "delete")
        path = {name: c.value for name, c in counters.items()}
        decode = {
            "dat_bytes": dat_size, "live_extent": extent,
            "journalled_deletes": len(doomed),
            "rebuild_seconds": rebuild_s,
            "rebuild_launches": rebuild_launches,
            "decode_seconds": decode_s,
            "GBps": extent / (rebuild_s + decode_s) / 1e9,
        }
        say(f"ec.decode: rebuild of {list(lost)} {rebuild_s:.3f} s "
            f"({rebuild_launches} launches), .dat + .idx {decode_s:.3f} s; "
            f"{extent} bytes = {decode['GBps']:.3f} GB/s; .dat hashes equal "
            "to the original's live extent, .idx = .ecx + "
            f"{len(doomed)} tombstones")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # outside the path's count: the route crossover
    rows, cross = crossover(torch, dev, args.seed, agree, args.reps)
    for row in rows:
        say(f"crossover n={row['n']}: native {row['native_ms']:.4f} ms, "
            f"kernel (H2D + launch + D2H) {row['kernel_ms']:.4f} ms")
    say("crossover: the kernel route is faster "
        + (f"from n = {cross} bytes on" if cross else "at no n measured")
        + f"; the codec ships a floor of {floor} bytes")
    return {
        "needle_volume": {"dat_bytes": dat_size, "live": len(live),
                          "deleted": len(deleted), "seed": args.seed},
        "reads": reads, "decode": decode, "crossover": rows,
        "crossover_bytes": cross, "floor_bytes": floor,
        "host_dispatches_in_path": path["codec_host"],
    }, path


def route_delta(link, before) -> dict[str, int]:
    """``seaweedfs_codec_route_total`` since ``before`` (its
    ``values()``), as ``{"path/reason": count}``."""
    return {f"{path}/{reason}": int(v - before.get((path, reason), 0.0))
            for (path, reason), v in sorted(link.ROUTE_TOTAL.values().items())
            if v != before.get((path, reason), 0.0)}


@contextlib.contextmanager
def scratch_recording():
    """Fresh copies of everything recording one codec dispatch writes:
    the profiler's and the ledger's families, the route counter, the
    EWMA gauge, the span histogram, the link state, the ledger and the
    span ring. The originals come back on exit."""
    from seaweedfs_tpu_torch.ops import link, profiler
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.telemetry import devices
    from seaweedfs_tpu_torch.tracing import recorder

    def fresh(family):
        new = type(family)(family.name, family.help, family.label_names)
        if isinstance(family, metrics.Histogram):
            new.buckets = list(family.buckets)
        return new

    families = [(profiler, "DISPATCH_SECONDS"), (profiler, "DISPATCH_BYTES"),
                (link, "ROUTE_TOTAL"), (link, "LINK_GBPS"),
                (devices, "DEVICE_BUSY_SECONDS"),
                (devices, "DEVICE_DISPATCH_TOTAL"),
                (devices, "DEVICE_TRANSFER_BYTES"),
                (recorder, "SPAN_SECONDS")]
    swaps = [(mod, name, fresh(getattr(mod, name)))
             for mod, name in families]
    swaps += [(link, "STATE", link.LinkState()),
              (devices, "LEDGER", devices.DeviceLedger()),
              (recorder, "RECORDER", recorder.SpanRecorder())]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, new in swaps:
            setattr(mod, name, new)
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def recording_cost(calls: int, in_bytes: int) -> float:
    """Microseconds one kernel dispatch inside a traced encode pays to
    record itself (the profiler's families, the ledger, a span under a
    root span, the route counter, the EWMA), on scratch copies of all
    of them: the process's own records are left as they were."""
    from seaweedfs_tpu_torch import tracing
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.storage.erasure_coding import constants as C

    with scratch_recording():
        with tracing.start_span("chip_smoke", "recording cost") as root:
            t0 = time.perf_counter()
            for _ in range(calls):
                codec_mod._record("cuda", "link", C.PARITY_SHARDS,
                                  C.DATA_SHARDS, in_bytes, 1e-3, root)
            return (time.perf_counter() - t0) / calls * 1e6


def phase_routing(args, torch, dev, smi, volume_hashes, reset_counts,
                  counters):
    """Phase 11: routing and observability at full size, on the default
    link-aware codec. Returns the phase's row and the launch counts of
    its path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seaweedfs_tpu_torch import fault, tracing
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.ops import link, profiler
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.ops.kernels import gf_swar
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        constants as C,
        encoder,
        rebuild,
    )
    from seaweedfs_tpu_torch.telemetry import devices, phases

    size = args.volume_mib * MIB
    widths = encode_widths(size)
    floor = codec_mod.DEVICE_MIN_BYTES
    above = sum(w >= floor for w in widths)
    check(len(set(widths)) == 1, f"encode widths {sorted(set(widths))}: "
                                 "phase 11 wants one width")
    in_bytes = C.DATA_SHARDS * widths[0]

    # -- the probe, on a fresh link state --------------------------------
    link.STATE = link.LinkState()
    thirty_gb = 30 * 10**9
    pipe_cold = encoder.choose_pipeline(thirty_gb)
    probe = link.probe(dev)
    for key in ("h2d_gbps", "d2h_gbps", "rtt_s"):
        check(probe[key] > 0, f"link probe {key} = {probe[key]}")
    for key in ("h2d_gbps", "d2h_gbps"):
        check(probe[key] <= 100, f"link probe {key} = {probe[key]}: past "
                                 "any PCIe link of this card")
    say(f"link probe ({smi}): H2D {probe['h2d_gbps']:.3f} GB/s, D2H "
        f"{probe['d2h_gbps']:.3f} GB/s at {int(probe['probe_bytes'])} "
        f"bytes, rtt {probe['rtt_s'] * 1e6:.1f} us; seeded device estimate "
        f"{link.estimates()['device']:.3f} GB/s")

    rs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev)
    check(rs.link_aware, "the default codec is not link-aware")
    work = tempfile.mkdtemp(prefix="chip_smoke-route-", dir=args.workdir)
    try:
        base = os.path.join(work, "1")
        make_volume(base, size, args.seed)

        def encode_checked(label, pt=None):
            """One encode of the volume: its route split, checked against
            the launches and host dispatches, and its shards' hashes."""
            before = link.ROUTE_TOTAL.values()
            launches0 = gf_swar.LAUNCHES.value
            host0 = codec_mod.HOST_DISPATCHES.value
            t0 = time.perf_counter()
            encoder.write_ec_files(base, rs=rs, phases=pt)
            secs = time.perf_counter() - t0
            routes_ = route_delta(link, before)
            device = sum(v for k, v in routes_.items()
                         if k.startswith("device/"))
            host = sum(v for k, v in routes_.items()
                       if k.startswith("host/"))
            launches = gf_swar.LAUNCHES.value - launches0
            host_dispatches = codec_mod.HOST_DISPATCHES.value - host0
            check("device/error" not in routes_
                  and "host/error" not in routes_,
                  f"{label}: failed dispatches {routes_}")
            check(launches == device,
                  f"{label}: {launches} gf_swar launches, {device} "
                  "device-routed dispatches")
            check(host_dispatches == host,
                  f"{label}: {host_dispatches} native dispatches, {host} "
                  "host-routed")
            check(launches + host_dispatches == len(widths),
                  f"{label}: {launches} + {host_dispatches} dispatches, "
                  f"the encode has {len(widths)}")
            device_above = device - routes_.get("device/size", 0)
            check(above == 0 or device_above > 0,
                  f"{label}: no above-floor dispatch reached the kernel")
            for i in range(C.TOTAL_SHARDS):
                check(sha256_file(base + C.to_ext(i)) == volume_hashes[i],
                      f"{label}: shard {i} differs from phase 5's")
            row = {
                "seconds": secs, "GBps": size / secs / 1e9,
                "routes": routes_, "launches": launches,
                "host_dispatches": host_dispatches,
                "device_share_above_floor": (device_above / above
                                             if above else None),
                "estimates": link.estimates(),
            }
            say(f"{label}: {secs:.3f} s = {row['GBps']:.3f} GB/s; routes "
                f"{json.dumps(routes_)}; {launches} gf_swar launches, "
                f"{host_dispatches} native; device share of the {above} "
                f"above-floor dispatches {device_above}/{above}; EWMAs "
                f"{json.dumps(row['estimates'])}; shards hash equal to "
                "phase 5's")
            return row

        # -- two encodes, the first under a root span with a PhaseTimer --
        reset_counts()
        ledger0 = devices.LEDGER.baseline()
        hist0 = phases.PHASE_SECONDS.snapshot()
        with tracing.start_span("chip_smoke", "ec.encode") as root:
            pt = phases.PhaseTimer("ec.encode")
            encodes = [encode_checked("routed encode 1", pt)]
            summary = pt.finish()
        encodes.append(encode_checked("routed encode 2"))

        # -- the phase spans, the histogram and the codec spans ----------
        spans = tracing.RECORDER.spans(trace_id=root.trace_id)
        phase_spans = [sp for sp in spans if sp.component == "phase"]
        codec_spans = [sp for sp in spans if sp.component == "codec"]
        check(sorted(sp.op for sp in phase_spans)
              == sorted(f"ec.encode.{p}" for p in summary["phases"]),
              f"phase spans {[sp.op for sp in phase_spans]} for phases "
              f"{sorted(summary['phases'])}")
        check(all(sp.parent_id == root.span_id
                  for sp in phase_spans + codec_spans),
              "a phase or codec span is not under the encode's root span")
        check(len(codec_spans) == len(widths)
              and sum(sp.op == "encode(cuda,4x10)" for sp in codec_spans)
              == encodes[0]["launches"],
              f"{len(codec_spans)} codec spans under the root span for "
              f"{len(widths)} dispatches, {encodes[0]['launches']} on the "
              "card")
        hist1 = phases.PHASE_SECONDS.snapshot()
        for p in summary["phases"]:
            key = ("ec.encode", p)
            got = hist1[key][1] - hist0.get(key, ([], 0, 0.0))[1]
            check(got == 1, f"seaweedfs_phase_seconds{key}: {got} "
                            "observations from one finish()")
        say(f"phases under a root span: {len(phase_spans)} phase spans and "
            f"{len(codec_spans)} codec spans under it, one "
            "seaweedfs_phase_seconds observation a phase")
        say(phases.summarize_line(summary))
        for line in phases.render_waterfall(summary).splitlines():
            say(line)

        # -- the device ledger --------------------------------------------
        ledger = devices.LEDGER.snapshot(ledger0)
        device_routed = sum(e["launches"] for e in encodes)
        rows = {r["device"]: r for r in ledger["devices"]}
        card_row = rows.get("0", {"dispatches": 0, "h2d_bytes": 0,
                                  "busy_s": 0.0})
        check(card_row["dispatches"] == device_routed,
              f"ledger row 0: {card_row['dispatches']} dispatches, "
              f"{device_routed} device-routed")
        check(card_row["h2d_bytes"] == device_routed * in_bytes,
              f"ledger row 0: {card_row['h2d_bytes']} H2D bytes, "
              f"{device_routed * in_bytes} device-routed input bytes")
        lanes = {r["lane"]: r for r in ledger["lanes"]}
        check(list(lanes) == ["0"]
              and lanes["0"]["chunks"] == len(encodes) * len(widths),
              f"staging lanes {ledger['lanes']}: one lane, "
              f"{len(encodes) * len(widths)} chunks wanted")
        say(f"device ledger over the two encodes: row 0 "
            f"{card_row['dispatches']} dispatches, busy "
            f"{card_row['busy_s']:.6f} s, {card_row['h2d_bytes']} H2D "
            f"bytes; staging lanes {json.dumps(ledger['lanes'])}")

        # -- the pipeline's sizing, cold and warm -------------------------
        pipe_warm = encoder.choose_pipeline(thirty_gb)
        say(f"choose_pipeline(30 GB): cold {pipe_cold}, warm {pipe_warm} "
            "(batch bytes, depth); a reading, not a run")

        # -- named ranges in a torch.profiler trace -----------------------
        profiler.annotate(True)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                encodes.append(encode_checked("profiled encode"))
                torch.cuda.synchronize()
        finally:
            profiler.annotate(False)
        # each range is a host event, and the trace mirrors it as a
        # device-side user annotation over the work it launched
        label = "codec.encode(cuda,4x10)"
        ranges = sum(e.name == label and e.device_type == DeviceType.CPU
                     for e in prof.events())
        mirrored = sum(e.name == label and e.device_type == DeviceType.CUDA
                       for e in prof.events())
        check(ranges == encodes[-1]["launches"],
              f"{ranges} {label} ranges in the profile, "
              f"{encodes[-1]['launches']} device-routed dispatches")
        say(f"torch.profiler: {ranges} {label} ranges, one a device-routed "
            f"dispatch ({mirrored} device-side annotations)")

        # -- the fault seam -----------------------------------------------
        fault.REGISTRY.inject("codec.dispatch", count=1)
        try:
            encoder.write_ec_files(base, rs=rs)
            injected = None
        except fault.FaultInjected as e:
            injected = e
        finally:
            fault.REGISTRY.clear()
        check(injected is not None and injected.point == "codec.dispatch",
              "codec.dispatch armed once: write_ec_files did not raise "
              "FaultInjected")
        fired = fault.FAULT_INJECTED.values().get(
            ("codec.dispatch", "error"))
        check(fired == 1, "seaweedfs_fault_injected_total"
                          f"{{codec.dispatch,error}} reads {fired}, not 1")
        encodes.append(encode_checked("encode after the fault"))
        say("fault seam: codec.dispatch armed once raised FaultInjected "
            "out of write_ec_files, counted once; the next encode is "
            "byte-exact")

        # -- a rebuild on the link-aware codec ----------------------------
        lost = (0, 5, 11, 13)
        rebuild_dispatches = len(rebuild_widths(
            os.path.getsize(base + C.to_ext(1))))
        for sid in lost:
            os.remove(base + C.to_ext(sid))
        before = link.ROUTE_TOTAL.values()
        launches0 = gf_swar.LAUNCHES.value
        host0 = codec_mod.HOST_DISPATCHES.value
        t0 = time.perf_counter()
        got_ids = rebuild.rebuild_ec_files(base, rs=rs)
        rebuild_s = time.perf_counter() - t0
        rebuild_routes = route_delta(link, before)
        device = sum(v for k, v in rebuild_routes.items()
                     if k.startswith("device/"))
        host = sum(v for k, v in rebuild_routes.items()
                   if k.startswith("host/"))
        launches = gf_swar.LAUNCHES.value - launches0
        host_dispatches = codec_mod.HOST_DISPATCHES.value - host0
        check(got_ids == list(lost), f"routed rebuild ids {got_ids}")
        check((launches, host_dispatches) == (device, host)
              and device + host == rebuild_dispatches,
              f"routed rebuild: {launches} gf_swar launches and "
              f"{host_dispatches} native for routes {rebuild_routes}; the "
              f"rebuild has {rebuild_dispatches} dispatches")
        for sid in lost:
            check(sha256_file(base + C.to_ext(sid)) == volume_hashes[sid],
                  f"routed rebuild: shard {sid} differs from phase 5's")
        rebuilt = {"lost": list(lost), "seconds": rebuild_s,
                   "routes": rebuild_routes, "launches": launches,
                   "host_dispatches": host_dispatches,
                   "estimates": link.estimates()}
        say(f"routed rebuild of {list(lost)}: {rebuild_s:.3f} s; routes "
            f"{json.dumps(rebuild_routes)}; {launches} gf_swar launches, "
            f"{host_dispatches} native; EWMAs "
            f"{json.dumps(rebuilt['estimates'])}; shards hash equal to "
            "phase 5's")
        path = {name: c.value for name, c in counters.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- what recording a dispatch costs on this host ---------------------
    calls = 2000
    routes_before, state_before = link.ROUTE_TOTAL.values(), link.STATE
    record_us = recording_cost(calls, in_bytes)
    check(link.ROUTE_TOTAL.values() == routes_before
          and link.STATE is state_before,
          "measuring the recording cost changed the process's records")
    say(f"recording one dispatch (profiler, ledger, span, route counter, "
        f"EWMA): {record_us:.2f} us on the host clock, mean of {calls}, "
        "on scratch copies of the records")
    return {
        "record_us": record_us,
        "probe": probe, "card": smi, "floor_bytes": floor,
        "dispatches_an_encode": len(widths), "above_floor": above,
        "encodes": encodes, "rebuild": rebuilt, "phases": summary,
        "ledger": {"device_0": card_row, "lanes": ledger["lanes"]},
        "pipeline_30GB": {"cold": pipe_cold, "warm": pipe_warm},
        "profiler_ranges": ranges, "faults_injected": fired,
    }, path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024,
                    help="size of the generated .dat volume")
    ap.add_argument("--workdir", default=None,
                    help="where the volume and shards go (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch-volumes", type=int, default=4,
                    help="volumes of one size in phase 9's batch encode")
    ap.add_argument("--batch-volume-mib", type=int, default=256)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    # phase 7's autotuner measures into a cache of its own, never the
    # repository's
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke-autotune-")
    os.environ["SEAWEEDFS_TPU_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tune_dir, "autotune.json")
    os.environ["SEAWEEDFS_TPU_TORCH_AUTOTUNE"] = "1"
    try:
        return run(args, torch, here)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


KERNELS = {
    # name: (library, source, TPU kernels it replaces: the first in
    # "replaces", the others in "also_replaces")
    "gf_swar": ("gf_swar", "seaweedfs_tpu_torch/ops/kernels/csrc/gf_swar.cu",
                "seaweedfs_tpu/ops/pallas/gf_kernel.py:146"),
    "gf_repack": ("gf_repack",
                  "seaweedfs_tpu_torch/ops/kernels/csrc/gf_repack.cu",
                  "seaweedfs_tpu/ops/pallas/gf_kernel.py:266",
                  "tools/exp_dev8.py:31", "tools/exp_dev8b.py:23",
                  "tools/exp_dev8b.py:32"),
    "gf_unpack": ("gf_repack",
                  "seaweedfs_tpu_torch/ops/kernels/csrc/gf_repack.cu",
                  "seaweedfs_tpu/ops/pallas/gf_kernel.py:279"),
    "gf_swar_u8": ("gf_swar_u8",
                   "seaweedfs_tpu_torch/ops/kernels/csrc/gf_swar_u8.cu",
                   "seaweedfs_tpu/ops/pallas/gf_kernel.py:202"),
    "gf_bitplane": ("gf_bitplane",
                    "seaweedfs_tpu_torch/ops/kernels/csrc/gf_bitplane.cu",
                    "seaweedfs_tpu/ops/pallas/gf_kernel.py:93"),
    "gf_vpu": ("gf_vpu", "seaweedfs_tpu_torch/ops/kernels/csrc/gf_vpu.cu",
               "seaweedfs_tpu/ops/pallas/gf_kernel.py:106"),
    "gf_fused_u8": ("gf_fused_u8",
                    "seaweedfs_tpu_torch/ops/kernels/csrc/gf_fused_u8.cu",
                    "tools/exp_dev8b.py:54"),
    "gf_swar_fusedv": ("gf_swar",
                       "seaweedfs_tpu_torch/ops/kernels/csrc/gf_swar.cu",
                       "tools/exp_batched.py:27"),
    "gf_swar_batch_fastest": (
        "gf_swar", "seaweedfs_tpu_torch/ops/kernels/csrc/gf_swar.cu",
        "tools/exp_batched.py:64"),
}
# the kernels each path must launch (counts read around the path's run)
PATH_KERNELS = {
    "ec_files": ("gf_swar",),
    "device_resident": ("gf_swar", "gf_repack", "gf_unpack", "gf_swar_u8",
                        "gf_bitplane", "gf_vpu"),
    "sweeps": ("gf_swar", "gf_repack", "gf_swar_u8", "gf_bitplane",
               "gf_vpu", "gf_fused_u8", "gf_swar_fusedv",
               "gf_swar_batch_fastest"),
    "batch_encode": ("gf_swar",),
    "read_decode": ("gf_swar",),
    "routing": ("gf_swar",),
}


def run(args, torch, here: str) -> int:
    from seaweedfs_tpu_torch.ops import autotune, gf256
    from seaweedfs_tpu_torch import native
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.ops.kernels import (
        build,
        gf_bitplane,
        gf_fused_u8,
        gf_kernel,
        gf_repack,
        gf_swar,
        gf_swar_u8,
        gf_vpu,
    )
    from seaweedfs_tpu_torch.ops.timing import l2_flusher, time_ms
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        constants as C,
        encoder,
        layout,
        rebuild,
    )
    from seaweedfs_tpu_torch.telemetry.phases import PhaseTimer

    counters = {
        "gf_swar": gf_swar.LAUNCHES,
        "gf_repack": gf_repack.REPACK_LAUNCHES,
        "gf_unpack": gf_repack.UNPACK_LAUNCHES,
        "gf_swar_u8": gf_swar_u8.LAUNCHES,
        "gf_bitplane": gf_bitplane.LAUNCHES,
        "gf_vpu": gf_vpu.LAUNCHES,
        "gf_fused_u8": gf_fused_u8.LAUNCHES,
        "gf_swar_fusedv": gf_swar.FUSEDV_LAUNCHES,
        "gf_swar_batch_fastest": gf_swar.BATCH_FASTEST_LAUNCHES,
        # the launches of gf_swar's three forms that took the compile-time
        # RS(10,4) parity instantiation
        "gf_swar_rs10x4": gf_swar.RS10X4_LAUNCHES,
        # and gf_swar_u8's launches in that form
        "gf_swar_u8_rs10x4": gf_swar_u8.RS10X4_LAUNCHES,
        # the codec's dispatches that took the native host route
        "codec_host": codec_mod.HOST_DISPATCHES,
    }
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    path_launches: dict[str, dict[str, int]] = {}

    def reset_counts():
        for counter in counters.values():
            counter.reset()

    def check_path(path):
        """Fail unless every kernel of ``path`` was launched in its run."""
        for name in PATH_KERNELS[path]:
            check(path_launches[path][name] > 0,
                  f"the {path} path launched no {name} kernel")

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
    libs = sorted({lib for lib, *_ in KERNELS.values()})
    t0 = time.perf_counter()
    build.prebuild(libs)
    for mod in (gf_swar, gf_repack, gf_swar_u8, gf_bitplane, gf_vpu,
                gf_fused_u8):
        mod.library()
    say(f"build {', '.join(libs)}: {time.perf_counter() - t0:.3f} s wall, "
        "one nvcc each, in parallel")
    # the host codec of the codec's native route and the needle CRC
    t0 = time.perf_counter()
    native_lib = native.compile_library()
    native.library()
    say(f"build native host codec (g++ {' '.join(native.CXX_FLAGS)}): "
        f"{time.perf_counter() - t0:.3f} s -> "
        f"{os.path.relpath(native_lib, here)}")
    for lib in libs:
        info = build.build_info[lib]
        regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                           info["ptxas"])]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                                info["ptxas"]))
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem",
                                           info["ptxas"])]
        say(f"build {lib}: nvcc {info['seconds']:.3f} s -> "
            f"{os.path.relpath(info['path'], here)}; ptxas: {len(regs)} "
            f"kernels, registers {min(regs, default=0)}.."
            f"{max(regs, default=0)}, spill stores {spills} bytes, static "
            f"smem {max(smem, default=0)} bytes")
        if lib in ("gf_swar", "gf_swar_u8"):
            spilling = re.findall(
                r"Function properties for (\S+)\n\s+\d+ bytes stack frame, "
                r"([1-9]\d*) bytes spill stores", info["ptxas"])
            check(spills == 0, f"{lib} spills {spills} bytes: {spilling}")
    # the SWAR kernels' symbols: <form (0 run-time, 1 RS(10,4) constants),
    # O, W>
    for lib, symbol in (("gf_swar", "gf_swar_kernelILi0ELi4ELi1EE"),
                        ("gf_swar", "gf_swar_kernelILi0ELi4ELi2EE"),
                        ("gf_swar_u8", "gf_swar_u8_kernelILi0ELi4ELi1EE"),
                        ("gf_swar_u8", "gf_swar_u8_kernelILi0ELi4ELi2EE"),
                        ("gf_swar", "gf_swar_fusedv_kernelILi0ELi4ELi1EE"),
                        ("gf_swar",
                         "gf_swar_batch_fastest_kernelILi0ELi4ELi1EE")):
        forms = sass_doubling(nvcc, build.build_info[lib]["path"], symbol)
        say(f"SASS {symbol} doubling forms: " + ", ".join(
            f"{name} x{n}" for name, n in forms.items()))
        check(min(forms.values()) > 0 and len(set(forms.values())) == 1,
              f"the built doubling of {symbol} is no longer "
              f"{ALU_PER_DOUBLING} ALU + {FMA_PER_DOUBLING} FMA-pipe "
              "instructions; recount the bound")
    # the compile-time RS(10,4) form of both SWAR kernels, at each W: its
    # doublings keep their forms, except that ptxas issues some x<<1 as
    # IADD3 or LEA on the ALU pipe instead of IMAD.SHL, so 3 ALU + 2 FMA a
    # doubling stays the least work; and its XORs (LOP3s of an XOR truth
    # table) are at most the matrix's set bits, one LOP3 each, and fewer
    # where ptxas folds two XORs into one three-input LOP3. gf_swar's at
    # W = 1 is the count the bound takes. gf_swar_u8 holds the column's
    # algebra twice (the whole-word path and the byte path), so its counts
    # a word divide by the copies its doublings show.
    parity10 = gf256.parity_matrix(10, 4)
    set_bits = xor_ops(parity10, folded=False)
    fold_bits = xor_ops(parity10, folded=True)
    parity_xtimes = sum(
        int(c).bit_length() - 1
        for c in np.bitwise_or.reduce(parity10, axis=0))
    rs_xors = {}
    for lib in ("gf_swar", "gf_swar_u8"):
        path = build.build_info[lib]["path"]
        for w in range(1, gf_swar.max_width(4, gf_swar.FORM_RS10X4) + 1):
            symbol = f"{lib}_kernelILi1ELi4ELi{w}EE"
            ops = sass_opcodes(nvcc, path, symbol)
            forms = sass_doubling(nvcc, path, symbol)
            say(f"SASS {symbol} doubling forms: " + ", ".join(
                f"{name} x{n}" for name, n in forms.items()))
            others = [n for name, n in forms.items()
                      if name != "IMAD.SHL x<<1"]
            check(min(others) > 0 and len(set(others)) == 1
                  and forms["IMAD.SHL x<<1"] <= others[0],
                  f"the built doubling of {symbol} is no longer at least "
                  f"{ALU_PER_DOUBLING} ALU + {FMA_PER_DOUBLING} FMA-pipe "
                  "instructions; recount the bound")
            doubling_lop3 = sum(n for name, n in forms.items()
                                if name.startswith("LOP3"))
            # u32 words the thread's column algebra covers, all copies
            copies = max(1, round(forms["SHF.R x>>7"]
                                  / (parity_xtimes * 4 * w)))
            words = 4 * w * copies
            xors = sass_xor_lop3(nvcc, path, symbol) / words
            rest = (ops.get("LOP3", 0) - doubling_lop3) / words
            rs_xors[symbol] = xors
            say(f"SASS {symbol} opcodes (static): " + ", ".join(
                f"{op} x{n}" for op, n in list(ops.items())[:12])
                + f"; {copies} cop{'y' if copies == 1 else 'ies'} of the "
                f"algebra; XOR LOP3s a u32 word {xors:.2f} (LOP3s that are "
                f"no doubling's: {rest:.2f}; set bits {set_bits}, folded "
                f"in pairs {fold_bits})")
            check(xors <= set_bits,
                  f"{symbol} issues {xors:.2f} XOR LOP3s a word, more than "
                  f"the {set_bits} set bits of the parity")
    xor_per_word = rs_xors["gf_swar_kernelILi1ELi4ELi1EE"]
    say("SASS XOR LOP3s a u32 word of the compile-time RS(10,4) form: "
        + ", ".join(f"{sym} {n:.2f}" for sym, n in rs_xors.items()))
    # step d: the bound counts the least work. Where ptxas folds XORs, the
    # pair-folded count is it for every SWAR-family row; for the parity,
    # the built kernel's own count where that is lower still (every output
    # there has an odd number of terms, so a count below the pairs' means
    # a three-input XOR shared by two outputs)
    folded = xor_per_word < set_bits
    parity_xors = min(xor_per_word, fold_bits) if folded else set_bits
    say(f"bound: XORs counted {'folded' if folded else 'one per set bit'} "
        f"({parity_xors:g} a word for the RS(10,4) parity)")

    def work_of(matrix, n_bytes, batch=1):
        xors = parity_xors if np.array_equal(matrix, parity10) else None
        return swar_work(matrix, n_bytes, batch, folded=folded, xors=xors)
    # gf_fused_u8 does the same doublings; its index math adds forms of
    # its own (an IMAD.SHL by 2), so its counts are shown, not checked
    forms = sass_doubling(nvcc, build.build_info["gf_fused_u8"]["path"],
                          "gf_fused_u8_kernelILi4E")
    say("SASS gf_fused_u8_kernelILi4E doubling forms: " + ", ".join(
        f"{name} x{n}" for name, n in forms.items()))
    vpu_forms = sass_doubling(nvcc, build.build_info["gf_vpu"]["path"],
                              "gf_vpu_kernelILi4E", VPU_DOUBLING_FORMS)
    say("SASS gf_vpu_kernelILi4E doubling forms: " + ", ".join(
        f"{name} x{n}" for name, n in vpu_forms.items()))
    check(min(vpu_forms.values()) > 0 and len(set(vpu_forms.values())) == 1,
          f"the built doubling of gf_vpu is no longer {VPU_ALU_PER_DOUBLING} "
          f"ALU + {VPU_FMA_PER_DOUBLING} FMA-pipe instructions; recount the "
          "bound")
    vpu_ops = sass_opcodes(nvcc, build.build_info["gf_vpu"]["path"],
                           "gf_vpu_kernelILi4E")
    say("SASS gf_vpu_kernelILi4E opcodes (static): " + ", ".join(
        f"{op} x{n}" for op, n in list(vpu_ops.items())[:16]))
    fu_ops = sass_opcodes(nvcc, build.build_info["gf_fused_u8"]["path"],
                          "gf_fused_u8_kernelILi4E")
    say("SASS gf_fused_u8_kernelILi4E opcodes (static): " + ", ".join(
        f"{op} x{n}" for op, n in list(fu_ops.items())[:16]))
    # gf_bitplane: registers, spills and blocks of 256 threads an SM (by
    # registers) of each instantiation <MT, K slices unrolled>, in ptxas's
    # own register choice or held to a minimum of blocks (_held); none may
    # spill at MT <= 2, the m-tiles of every RS shape of the repository
    for name, targs, regs, spill in ptxas_entries(
            build.build_info["gf_bitplane"]["ptxas"],
            r"gf_bitplane_kernel(?:_held)?"):
        blocks = min(8, 65536 // (256 * (-(-regs // 8) * 8)))
        say(f"ptxas {name}<{', '.join(map(str, targs))}>: {regs} registers, "
            f"{spill} bytes spill stores, {blocks} blocks of 256 an SM by "
            "registers")
        check(targs[0] > 2 or spill == 0,
              f"{name}<{targs}> spills {spill} bytes at MT <= 2")
    bp_ops = sass_opcodes(nvcc, build.build_info["gf_bitplane"]["path"],
                          BITPLANE_SYMBOL)
    say(f"SASS {BITPLANE_SYMBOL} (RS(10,4): MT 2, 4 K slices) opcodes "
        "(static): " + ", ".join(
            f"{op} x{n}" for op, n in list(bp_ops.items())[:20]))
    check(bp_ops.get("IMMA", 0) > 0,
          "gf_bitplane's SASS holds no IMMA: the product is not on the int8 "
          "tensor cores")
    check(bp_ops.get("VOTE", 0) == 0,
          f"gf_bitplane's shipped kernel holds {bp_ops.get('VOTE', 0)} VOTE "
          "instructions; its pack gathers each byte in the lane")
    say(f"gf_bitplane pack: VOTE x{bp_ops.get('VOTE', 0)}, SHFL "
        f"x{bp_ops.get('SHFL', 0)} (static)")
    bp_forms, bp_counts = bitplane_counts(
        nvcc, build.build_info["gf_bitplane"]["path"], BITPLANE_SYMBOL, 2, 4,
        10)
    say("gf_bitplane ALU and FMA-pipe instructions a 32-column chunk at "
        "RS(10,4), static SASS, each with its time at [10,64MiB] on the "
        "pipes' peak (counts, not the bound): " + "; ".join(
            f"{scope} {alu:.1f} ALU, {fma:.1f} FMA, "
            f"{chunk_ms(alu, fma, 64 * MIB):.4f} ms"
            for scope, (alu, fma) in bp_counts.items())
        + " (forms: the design's own unpack and pack, its floor; loop: the "
        "whole-span loop; function: every body, the masked path included); "
        "static forms: " + ", ".join(
            f"{name} x{n}" for name, n in bp_forms.items()))

    # -- 2. kernel vs plain on the card -------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=dev, generator=gen)

    # per kernel: cases compared, bytes differing, max |got - want|
    stats = {name: {"cases": 0, "differing": 0, "worst": 0}
             for name in KERNELS}

    def agree(name, got, want, label):
        """Count one comparison of a kernel's output with its plain
        version; fail on any differing byte."""
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {label}: {got.dtype} {tuple(got.shape)} != "
              f"{want.dtype} {tuple(want.shape)}")
        diff = 0 if torch.equal(got, want) else int((got != want).sum())
        err = 0
        if diff:
            err = int((got.long() - want.long()).abs().max())
        st = stats[name]
        st["cases"] += 1
        st["differing"] += diff
        st["worst"] = max(st["worst"], err)
        check(diff == 0, f"{name} differs from plain on {label}: {diff} "
                         "elements")

    def compare(matrix, data, label):
        coeff = gf_swar.coeff_from_reference(matrix)
        agree("gf_swar", gf_swar.gf_matmul(coeff, data),
              gf_swar.gf_matmul_plain(coeff, data), label)

    def rec_matrix_for(lost):
        present = [i for i in range(C.TOTAL_SHARDS) if i not in lost]
        return gf256.reconstruction_matrix(10, 4, present)[0]

    losses = ((3,), (0, 13), (0, 5, 11), (0, 5, 11, 13))
    rs_shapes = ((10, 4), (6, 3), (12, 4), (20, 4))
    for k, m in rs_shapes:
        for n in (1, 4095, MIB, MIB + 3):
            compare(gf256.parity_matrix(k, m), rand(k, n),
                    f"parity({k},{m}) N={n}")
    compare(gf256.parity_matrix(10, 4), rand(3, 10, MIB),
            "batched [3,10,1MiB]")
    for lost in losses:
        compare(rec_matrix_for(lost), rand(10, 8 * MIB),
                f"reconstruct lost={lost}")
    # each coefficient form at each W, forced, on column-word counts with
    # tails past every W (n16 % W != 0), a batch, and the codec's widths
    marked = gf_swar.coeff_from_reference(parity10)
    check(marked.rs10x4, "the RS(10,4) parity is not marked for its "
                         "compile-time form")
    form_cases = (("RS(10,4) constants", marked),
                  ("RS(10,4) run-time", dataclasses.replace(marked,
                                                            rs10x4=False)),
                  ("rebuild {0,5,11,13} run-time",
                   gf_swar.coeff_from_reference(
                       rec_matrix_for((0, 5, 11, 13)))),
                  ("RS(12,4) run-time", gf_swar.coeff_from_reference(
                      gf256.parity_matrix(12, 4))))
    for label, coeff in form_cases:
        o, k = coeff.shape
        form = gf_swar.launch_plan(coeff, 1, 1, 1)[1]
        for w in gf_swar.WIDTHS[:gf_swar.WIDTHS.index(
                gf_swar.max_width(o, form)) + 1]:
            for batch, n16 in ((1, 1), (1, 3), (1, 4095), (3, 1027),
                               (1, MIB // 16 + 5), (1, MIB // 16),
                               (2, 8 * MIB // 16 + 1)):
                x = rand(batch, k, 16 * n16)
                out = torch.empty((batch, o, 16 * n16), dtype=torch.uint8,
                                  device=dev)
                gf_swar.launch(coeff, x, out, width=w)
                agree("gf_swar", out, gf_swar.gf_matmul_plain(coeff, x),
                      f"{label} W={w} [{batch},{k},{n16}x16]")
    del x, out

    # gf_repack: the u32 words themselves; gf_unpack: the bytes back
    for label, x in (("[10,1]", rand(10, 1)), ("[10,4095]", rand(10, 4095)),
                     ("[10,1MiB+3]", rand(10, MIB + 3)),
                     ("[3,10,1MiB]", rand(3, 10, MIB)),
                     ("rows 0-9 of [14,1MiB]", rand(14, MIB)[:10]),
                     ("[10,64MiB]", rand(10, 64 * MIB))):
        n = x.shape[-1]
        for tile in sorted({gf_repack.choose_tile(n), 256, 4}):
            words = gf_repack.repack(x, tile)
            agree("gf_repack", words, gf_repack.repack_plain(x, tile),
                  f"{label} tile {tile}")
            agree("gf_unpack", gf_repack.unpack(words, tile, n),
                  gf_repack.unpack_plain(words, tile, n),
                  f"{label} tile {tile}")
    # gf_swar_u8 at its wrapper's plan: ragged widths, a strided row view,
    # a batch, four RS shapes
    for k, m in rs_shapes:
        coeff = gf256.parity_matrix(k, m)
        for label, x in ((f"[{k},1]", rand(k, 1)),
                         (f"[{k},4095]", rand(k, 4095)),
                         (f"[{k},1MiB+3]", rand(k, MIB + 3)),
                         (f"rows 0-{k - 1} of [{k + m},1MiB+3]",
                          rand(k + m, MIB + 3)[:k]),
                         (f"[3,{k},1MiB]", rand(3, k, MIB))):
            agree("gf_swar_u8", gf_swar_u8.gf_matmul(coeff, x),
                  gf_swar_u8.gf_matmul_plain(coeff, x),
                  f"parity({k},{m}) {label}")
    # and each coefficient form at each W, forced: column-word counts no W
    # divides, widths with a partial last word, rows 0-9 of a [14, N]
    # tensor (16-byte row stride: whole words; odd stride: the byte path),
    # batches, and rows that start one byte past an aligned address

    def u8_cases(k):
        yield f"[{k},16x4095]", rand(k, 16 * 4095)
        yield f"[{k},16x(64Ki+5)]", rand(k, MIB + 80)
        yield f"[{k},8MiB+16]", rand(k, 8 * MIB + 16)
        yield f"[{k},1]", rand(k, 1)
        yield f"[{k},4095]", rand(k, 4095)
        yield f"[{k},1MiB+3]", rand(k, MIB + 3)
        yield f"rows 0-{k - 1} of [{k + 4},1MiB]", rand(k + 4, MIB)[:k]
        yield (f"rows 0-{k - 1} of [{k + 4},1MiB+3]",
               rand(k + 4, MIB + 3)[:k])
        yield f"[3,{k},16x4097]", rand(3, k, 16 * 4097)
        yield f"[2,{k},1MiB+5]", rand(2, k, MIB + 5)
        yield (f"[{k},1MiB+16] one byte past aligned",
               rand(k, MIB + 17)[:, 1:])

    for label, coeff in form_cases:
        o, k = coeff.shape
        form = gf_swar.launch_plan(coeff, 1, 1, 1)[1]
        for w in range(1, gf_swar.max_width(o, form) + 1):
            for case, x in u8_cases(k):
                agree("gf_swar_u8", gf_swar_u8.gf_matmul(coeff, x, width=w),
                      gf_swar_u8.gf_matmul_plain(coeff, x),
                      f"{label} W={w} {case}")
    del x
    # gf_bitplane: four RS shapes, four loss patterns
    for k, m in rs_shapes:
        coeff = gf256.parity_matrix(k, m)
        for label, x in ((f"[{k},4095]", rand(k, 4095)),
                         (f"[{k},1MiB+3]", rand(k, MIB + 3)),
                         (f"rows 0-{k - 1} of [{k + m},1MiB]",
                          rand(k + m, MIB)[:k]),
                         (f"[2,{k},1MiB]", rand(2, k, MIB))):
            agree("gf_bitplane", gf_bitplane.gf_matmul(coeff, x),
                  gf_bitplane.gf_matmul_plain(coeff, x),
                  f"parity({k},{m}) {label}")
    for lost in losses:
        r = rec_matrix_for(lost)
        x = rand(10, 8 * MIB)
        agree("gf_bitplane", gf_bitplane.gf_matmul(r, x),
              gf_bitplane.gf_matmul_plain(r, x), f"reconstruct lost={lost}")
    # the edges of its spans: widths one short of and one past a whole
    # number of spans (a few, and more than the grid's warps take at once),
    # rows one byte past an aligned address and with an odd stride (the
    # masked path throughout), aligned strided rows, a batch, o = 5 and 6
    # (padded m-tiles), o = 16 and k = 64. The longest span any
    # instantiation takes, 4 chunks of 32 columns, is a multiple of every
    # other, and one chunk less a column is shorter than any
    span = 4 * 32
    edge_rng = np.random.default_rng(args.seed)
    edge_matrices = [("parity(10,4)", parity10),
                     ("rebuild {0,5,11,13}", rec_matrix_for((0, 5, 11, 13)))]
    edge_matrices += [(f"random {o}x{k}",
                       edge_rng.integers(0, 256, (o, k), dtype=np.uint8))
                      for o, k in ((5, 10), (6, 10), (4, 64), (16, 64))]
    for label, coeff in edge_matrices:
        o, k = coeff.shape
        spans = 3 if k > 16 else 20011
        cases = [(f"[{k},{spans}x{span}-1]", rand(k, spans * span - 1)),
                 (f"[{k},{spans}x{span}+1]", rand(k, spans * span + 1)),
                 (f"[{k},3x{span}+1]", rand(k, 3 * span + 1)),
                 (f"[{k},{span}-1]", rand(k, span - 1)),
                 (f"[{k},31]", rand(k, 31)),
                 (f"[{k},{spans}x{span}] one byte past aligned",
                  rand(k, spans * span + 1)[:, 1:]),
                 (f"rows 0-{k - 1} of [{k + 3},{spans}x{span}+3]",
                  rand(k + 3, spans * span + 3)[:k]),
                 (f"rows 0-{k - 1} of [{k + 4},{spans}x{span}]",
                  rand(k + 4, spans * span)[:k]),
                 (f"[3,{k},{spans}x{span}+5]", rand(3, k, spans * span + 5))]
        for case, x in cases:
            agree("gf_bitplane", gf_bitplane.gf_matmul(coeff, x),
                  gf_bitplane.gf_matmul_plain(coeff, x), f"{label} {case}")
    del x
    # gf_vpu: the route's inputs (ragged, strided rows, a batch), four RS
    # shapes and four loss patterns
    for k, m in rs_shapes:
        coeff = gf256.parity_matrix(k, m)
        for label, x in ((f"[{k},1]", rand(k, 1)),
                         (f"[{k},4095]", rand(k, 4095)),
                         (f"[{k},1MiB+3]", rand(k, MIB + 3)),
                         (f"rows 0-{k - 1} of [{k + m},1MiB+3]",
                          rand(k + m, MIB + 3)[:k]),
                         (f"[3,{k},1MiB]", rand(3, k, MIB))):
            agree("gf_vpu", gf_vpu.gf_matmul(coeff, x),
                  gf_vpu.gf_matmul_plain(coeff, x),
                  f"parity({k},{m}) {label}")
    for lost in losses:
        r = rec_matrix_for(lost)
        x = rand(10, 8 * MIB)
        agree("gf_vpu", gf_vpu.gf_matmul(r, x), gf_vpu.gf_matmul_plain(r, x),
              f"reconstruct lost={lost}")
    # gf_fused_u8: the sweep's tiles, a scalar tile (quarter of 25 bytes),
    # a ragged width and strided rows
    for k, m in rs_shapes:
        coeff = gf256.parity_matrix(k, m)
        for tile in (8192, 16384, 32768, 100):
            for label, x in ((f"[{k},1MiB+3]", rand(k, MIB + 3)),
                             (f"rows 0-{k - 1} of [{k + m},1MiB]",
                              rand(k + m, MIB)[:k]),
                             (f"[2,{k},65536]", rand(2, k, 65536))):
                agree("gf_fused_u8", gf_fused_u8.gf_matmul(coeff, x, tile),
                      gf_fused_u8.gf_matmul_plain(coeff, x, tile),
                      f"parity({k},{m}) tile {tile} {label}")
    for lost in losses:
        r = rec_matrix_for(lost)
        x = rand(10, 8 * MIB)
        agree("gf_fused_u8", gf_fused_u8.gf_matmul(r, x, 16384),
              gf_fused_u8.gf_matmul_plain(r, x, 16384),
              f"reconstruct lost={lost} tile 16384")
    # gf_swar's two word forms: V volumes of u32 words, ragged word counts

    def words_plain(coeff, words):
        return gf_swar.gf_matmul_plain(
            coeff, words.view(torch.uint8)).view(torch.int32)

    for name, form in (("gf_swar_fusedv", gf_swar.gf_matmul_fusedv),
                       ("gf_swar_batch_fastest",
                        gf_swar.gf_matmul_batch_fastest)):
        for k, m in rs_shapes:
            coeff = gf256.parity_matrix(k, m)
            for v, n4 in ((1, 1001), (3, MIB // 4), (8, 2 * MIB),
                          (8, 2 * MIB + 4)):
                w = rand(v, k, 4 * n4).view(torch.int32)
                agree(name, form(coeff, w), words_plain(coeff, w),
                      f"parity({k},{m}) [{v},{k},{n4}] words")
        for lost in losses:
            r = rec_matrix_for(lost)
            w = rand(8, 10, 4 * MIB).view(torch.int32)
            agree(name, form(r, w), words_plain(r, w),
                  f"reconstruct lost={lost} [8,10,1Mi] words")
    for name, st in stats.items():
        say(f"{name} vs plain: {st['cases']} cases, {st['differing']} "
            f"elements differ, max abs err {st['worst']} (tolerance 0: "
            "GF(2^8) arithmetic is exact)")

    # -- 3. timing ----------------------------------------------------------
    flush = l2_flusher(dev)

    rec_matrix = rec_matrix_for((0, 5, 11, 13))
    shapes = [
        ("encode [10,1MiB]->[4,1MiB]", gf256.parity_matrix(10, 4), MIB),
        ("rebuild [10,8MiB]->[4,8MiB]", rec_matrix, 8 * MIB),
        ("encode [10,64MiB]->[4,64MiB]", gf256.parity_matrix(10, 4),
         64 * MIB),
    ]
    plain_reps = max(3, args.reps // 4)
    timings = {name: [] for name in KERNELS}

    def timed(name, label, fn, plain, work, library=None, **extra):
        """Time ``fn`` (and ``plain``, and ``library``, where given)
        beside the bound of ``work``; a SWAR-family row also gives the
        bound as it was first counted (``unfolded``: one LOP3 a set
        bit)."""
        ms = time_ms(fn, args.reps, 3, flush)
        plain_ms = time_ms(plain, plain_reps, 3, flush) if plain else None
        library_ms = (time_ms(library, args.reps, 3, flush)
                      if library else None)
        unfolded = extra.pop("unfolded", None)
        before = extra.pop("before", None)
        moved, alu, fma, *tensor = work
        bound_ms, bound_by = bound(moved, alu, fma, *tensor)
        row = {
            "shape": label, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": moved, "alu_ops": alu,
            "fma_ops": fma, "bound_share": bound_ms / ms, **extra,
        }
        if tensor:
            row["tensor_ops"] = tensor[0]
        old = ""
        if unfolded is not None:
            row["bound_ms_unfolded"] = bound(*unfolded)[0]
            row["bound_share_unfolded"] = row["bound_ms_unfolded"] / ms
            old = (f"; one LOP3 a set bit: {row['bound_ms_unfolded']:.4f} "
                   f"ms, {100 * row['bound_share_unfolded']:.1f}%")
        if before is not None:  # printed only: the kernels line keeps
            before_ms, before_by = bound(*before)  # one bound a row
            old = (f"; counted as before (the first design's unpack and "
                   f"pack added): {before_ms:.4f} ms ({before_by}), "
                   f"{100 * before_ms / ms:.1f}%")
        timings[name].append(row)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        pl = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
        say(f"time {name} {label}: kernel {ms:.4f} ms{pl}{lib}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * row['bound_share']:.1f}% "
            f"of bound{old}")

    def swar_timed(name, label, fn, plain, matrix, n, batch=1, **extra):
        timed(name, label, fn, plain, work_of(matrix, n, batch),
              unfolded=swar_work(matrix, n, batch, folded=False), **extra)

    sms = gf_swar.sm_count(dev.index)

    def swar_forms(name, label, matrix, n, plan, run, plain):
        """Time SWAR kernel ``name`` on ``matrix`` over rows of ``n`` bytes
        at the (W, form) ``plan(coeff)`` its wrapper chooses, where
        ``run(coeff, None)`` launches it, then in each other form and W
        (``run(coeff, w)``), so each step's gain shows alone. Returns the
        chosen row."""
        coeff = gf_swar.coeff_from_reference(matrix)
        o, k = matrix.shape
        width, form = plan(coeff)
        form_name = "constants" if form == gf_swar.FORM_RS10X4 else "run-time"
        swar_timed(name, f"{label} ({form_name}, W={width} chosen)",
                   lambda: run(coeff, None), plain, matrix, n,
                   width=width, form=form_name)
        row = timings[name][-1]
        variants = [(coeff, form_name)]
        if coeff.rs10x4:
            variants.append((dataclasses.replace(coeff, rs10x4=False),
                             "run-time"))
        for c, f_name in variants:
            c_form = gf_swar.launch_plan(c, 1, 1, 1)[1]
            for w in range(1, gf_swar.max_width(o, c_form) + 1):
                if c is coeff and w == width:
                    continue
                swar_timed(name, f"{label} ({f_name}, W={w})",
                           lambda c=c, w=w: run(c, w), None, matrix, n,
                           width=w, form=f_name)
        return row

    for label, matrix, n in shapes:
        o, k = matrix.shape
        x = rand(1, k, n)
        out = torch.empty((1, o, n), dtype=torch.uint8, device=dev)
        row = swar_forms(
            "gf_swar", label, matrix, n,
            lambda c: gf_swar.launch_plan(c, n // 16, 1, sms),
            lambda c, w: gf_swar.launch(c, x, out, width=w),
            lambda: gf_swar.gf_matmul_plain(
                gf_swar.coeff_from_reference(matrix), x))
        row["input_GBps"] = k * n / row["ms"] / 1e6
        del x, out
    # gf_swar_u8 on the device-resident slab first (its row in the kernels
    # line), then at the codec's two shapes
    for label, matrix, n in (
            ("encode [10,64MiB]->[4,64MiB]", parity10, 64 * MIB),
            ("rebuild {0,5,11,13} [10,64MiB]->[4,64MiB]", rec_matrix,
             64 * MIB),
            ("encode [10,1MiB]->[4,1MiB]", parity10, MIB),
            ("rebuild [10,8MiB]->[4,8MiB]", rec_matrix, 8 * MIB)):
        x = rand(10, n)
        row = swar_forms(
            "gf_swar_u8", label, matrix, n,
            lambda c: gf_swar_u8.launch_plan(c, x, sms),
            lambda c, w: gf_swar_u8.gf_matmul(c, x, width=w),
            lambda: gf_swar_u8.gf_matmul_plain(matrix, x))
        row["input_GBps"] = 10 * n / row["ms"] / 1e6
        del x

    n = 64 * MIB
    tile = gf_repack.choose_tile(n)
    x = rand(10, n)
    words = torch.empty((10, n // 4), dtype=torch.int32, device=dev)

    def permute_copy(t, rows, q):  # the library call: one strided copy
        return t.view(rows, -1, 4, q).transpose(-1, -2).contiguous()

    timed("gf_repack", f"[10,64MiB] u8 -> [10,16Mi] u32, tile {tile}",
          lambda: gf_repack.repack(x, tile, out=words),
          lambda: gf_repack.repack_plain(x, tile), (2 * 10 * n, 0, 0),
          library=lambda: permute_copy(x, 10, tile // 4))
    parity_words = gf_repack.repack(rand(4, n), tile)
    timed("gf_unpack", f"[4,16Mi] u32 -> [4,64MiB] u8, tile {tile}",
          lambda: gf_repack.unpack(parity_words, tile, n),
          lambda: gf_repack.unpack_plain(parity_words, tile, n),
          (2 * 4 * n, 0, 0),
          library=lambda: permute_copy(parity_words.view(torch.uint8), 4,
                                       tile // 4))
    del words, parity_words
    chunk = 8 * MIB
    for label, matrix in (("encode [10,64MiB]->[4,64MiB]",
                           gf256.parity_matrix(10, 4)),
                          ("rebuild {0,5,11,13} [10,64MiB]->[4,64MiB]",
                           rec_matrix)):
        coeff = gf_swar.coeff_from_reference(matrix)
        # the plain bit-plane version of [10, 64 MiB] would hold 80 float32
        # bit rows of 64 Mi columns: it runs on 8 MiB column chunks
        timed("gf_bitplane", label,
              lambda: gf_bitplane.gf_matmul(matrix, x),
              lambda: [gf_bitplane.gf_matmul_plain(matrix, x[:, i:i + chunk])
                       for i in range(0, n, chunk)],
              bitplane_work(4, 10, n), before=bitplane_work_before(4, 10, n))
        timed("gf_vpu", label, lambda: gf_vpu.gf_matmul(coeff, x),
              lambda: gf_vpu.gf_matmul_plain(coeff, x), vpu_work(matrix, n))
        agree("gf_vpu", gf_vpu.gf_matmul(coeff, x),
              gf_vpu.gf_matmul_plain(coeff, x), label)
    parity10 = gf256.parity_matrix(10, 4)
    coeff = gf_swar.coeff_from_reference(parity10)
    for tile in (8192, 16384, 32768):
        label = f"encode [10,64MiB]->[4,64MiB], tile {tile}"
        swar_timed("gf_fused_u8", label,
                   lambda: gf_fused_u8.gf_matmul(coeff, x, tile),
                   lambda: gf_fused_u8.gf_matmul_plain(coeff, x, tile),
                   parity10, n, tile=tile)
        agree("gf_fused_u8", gf_fused_u8.gf_matmul(coeff, x, tile),
              gf_fused_u8.gf_matmul_plain(coeff, x, tile), label)
    del x
    # the batch of exp_batched and of the 8-volume encode: [8, 10, 8 MiB]
    # as u32 words, and gf_swar's own batch launch beside its two forms
    batch_words = rand(8, 10, 8 * MIB).view(torch.int32)
    label = "encode [8,10,2Mi] words -> [8,4,2Mi]"
    for name, form, threads_over in (
            ("gf_swar_fusedv", gf_swar.gf_matmul_fusedv, 1),
            ("gf_swar_batch_fastest", gf_swar.gf_matmul_batch_fastest, 8),
            ("gf_swar", gf_kernel.u32_route, 8)):
        width, _ = gf_swar.launch_plan(coeff, 8 * MIB // 16, threads_over,
                                       sms)
        swar_timed(name, f"{label} (constants, W={width} chosen)",
                   lambda: form(coeff, batch_words),
                   lambda: words_plain(coeff, batch_words), parity10,
                   8 * MIB, 8, width=width)
        agree(name, form(coeff, batch_words),
              words_plain(coeff, batch_words), label)
    del batch_words
    say("library call: none for gf_swar and its two word forms, gf_swar_u8, "
        "gf_bitplane, gf_vpu and gf_fused_u8 (no single PyTorch call "
        "computes a GF(2^8) matrix product); the repack's and unpack's is "
        "one permute(...).contiguous() copy")

    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
    try:
        say(f"workdir {work}: {shutil.disk_usage(work).free / 2**30:.1f} "
            "GiB free")
        # phases 4, 5, 9 and 10 pin their codecs to the size floor
        # (link_aware=False): their expected launches and host dispatches
        # follow from the widths alone; phase 11 drives the link-aware
        # default
        rs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev,
                     link_aware=False)

        # -- 4. golden fixture ----------------------------------------------
        # twice: with the floor at 0 every dispatch takes the kernel; at
        # the codec's own floor the encode's narrow chunks take the
        # native host codec, and the rebuild's window takes whichever
        # route its width gives. Both must give the golden bytes.
        golden = os.path.join(here, "tests", "golden", "1")
        gbase = os.path.join(work, "golden")

        def same(ext):
            with open(gbase + ext, "rb") as a, open(golden + ext, "rb") as b:
                return a.read() == b.read()

        golden_size = os.path.getsize(golden + ".dat")
        golden_shard = layout.shard_file_size(
            golden_size, GOLDEN_BLOCKS["large_block_size"],
            GOLDEN_BLOCKS["small_block_size"])
        golden_widths = (
            encode_widths(golden_size, **GOLDEN_BLOCKS)
            + rebuild_widths(golden_shard)
        )
        for floor in (0, rs.device_min_bytes):
            grs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev,
                          device_min_bytes=floor, link_aware=False)
            shutil.copy(golden + ".dat", gbase + ".dat")
            shutil.copy(golden + ".idx", gbase + ".idx")
            reset_counts()
            encoder.write_ec_files(gbase, rs=grs, **GOLDEN_BLOCKS)
            encoder.write_sorted_file_from_idx(gbase)
            for i in range(C.TOTAL_SHARDS):
                check(same(C.to_ext(i)),
                      f"golden shard {C.to_ext(i)} differs (floor {floor})")
            check(same(".ecx"), "golden .ecx differs")
            for sid in (0, 5, 11, 13):
                os.remove(gbase + C.to_ext(sid))
            check(rebuild.rebuild_ec_files(gbase, rs=grs) == [0, 5, 11, 13],
                  "golden rebuild ids")
            for i in range(C.TOTAL_SHARDS):
                check(same(C.to_ext(i)), f"golden rebuilt {C.to_ext(i)} "
                                         f"differs (floor {floor})")
            want = routes(golden_widths, floor)
            got = (gf_swar.LAUNCHES.value, codec_mod.HOST_DISPATCHES.value)
            check(got == want, f"golden encode + rebuild at floor {floor}: "
                               f"{got} (kernel, host) dispatches, the "
                               f"routing gives {want}")
            say(f"golden fixture at floor {floor} bytes: 14 shards, .ecx "
                "and rebuild of {0,5,11,13} byte-identical; "
                f"{got[0]} gf_swar launches, {got[1]} native host "
                "dispatches")

        # -- 5. the main path at full size ----------------------------------
        base = os.path.join(work, "1")
        size = args.volume_mib * MIB
        t0 = time.perf_counter()
        want_ecx = make_volume(base, size, args.seed)
        say(f"volume: {size} bytes from seed {args.seed} in "
            f"{time.perf_counter() - t0:.2f} s")
        n_rows = len(layout.encode_row_plan(size))
        # (kernel, host) dispatches the codec's routing gives the encode
        # and each rebuild
        enc_want = routes(encode_widths(size), rs.device_min_bytes)
        rebuild_want = routes(rebuild_widths(layout.shard_file_size(size)),
                              rs.device_min_bytes)

        staged0 = rs.staged_bytes
        reset_counts()
        pt = PhaseTimer("ec.encode")
        t0 = time.perf_counter()
        encoder.write_ec_files(base, rs=rs, phases=pt)
        encoder.write_sorted_file_from_idx(base)
        enc_s = time.perf_counter() - t0
        enc_launches = gf_swar.LAUNCHES.value
        enc_rs10x4 = gf_swar.RS10X4_LAUNCHES.value
        enc_host = codec_mod.HOST_DISPATCHES.value
        enc_staged = rs.staged_bytes - staged0
        summary = pt.summary()
        check((enc_launches, enc_host) == enc_want,
              f"encode made {(enc_launches, enc_host)} (kernel, host) "
              f"dispatches; the routing gives {enc_want}")

        hashes = {
            i: sha256_file(base + C.to_ext(i)) for i in range(C.TOTAL_SHARDS)
        }
        volume_hashes = dict(hashes)  # phase 11 encodes the volume again
        rebuilds = []
        for lost in ((0, 5, 11, 13), (3,)):
            for sid in lost:
                os.remove(base + C.to_ext(sid))
            before = gf_swar.LAUNCHES.value
            before_host = codec_mod.HOST_DISPATCHES.value
            before_rs = gf_swar.RS10X4_LAUNCHES.value
            staged0 = rs.staged_bytes
            t0 = time.perf_counter()
            got_ids = rebuild.rebuild_ec_files(base, rs=rs)
            rebuilds.append((lost, time.perf_counter() - t0,
                             gf_swar.LAUNCHES.value - before,
                             rs.staged_bytes - staged0))
            got_routes = (rebuilds[-1][2],
                          codec_mod.HOST_DISPATCHES.value - before_host)
            check(got_routes == rebuild_want,
                  f"rebuild {lost} made {got_routes} (kernel, host) "
                  f"dispatches; the routing gives {rebuild_want}")
            check(gf_swar.RS10X4_LAUNCHES.value == before_rs,
                  f"rebuild {lost} launched the compile-time parity form; "
                  "its matrices take the run-time form")
            check(got_ids == list(lost), f"rebuild ids {got_ids} != {lost}")
            check(rebuilds[-1][3] == 0,
                  f"rebuild {lost} staged {rebuilds[-1][3]} bytes; its "
                  "windows should be read into pinned buffers")
            for sid in lost:
                check(sha256_file(base + C.to_ext(sid)) == hashes[sid],
                      f"rebuilt shard {sid} (lost {lost}) hash differs")
        main_launches = gf_swar.LAUNCHES.value
        path_launches["ec_files"] = {name: c.value
                                     for name, c in counters.items()}
        check_path("ec_files")

        check(enc_launches == n_rows,
              f"encode launched {enc_launches} kernels for {n_rows} rows")
        check(enc_rs10x4 == enc_launches,
              f"encode launched {enc_rs10x4} of {enc_launches} kernels in "
              "the compile-time RS(10,4) form")
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
        rebuild_gbps = [size / r[1] / 1e9 for r in rebuilds]
        say(f"encode {size} bytes: {enc_s:.3f} s = {gbps:.3f} GB/s, "
            f"{enc_launches} launches ({n_rows} rows; {enc_rs10x4} in the "
            f"compile-time RS(10,4) form), {enc_staged} bytes staged; "
            "parity rows match the plain version")
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
                f"launches (all run-time form), {staged} bytes staged; "
                "hashes match")
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

    # -- 7. the device-resident path at full size ---------------------------
    card = torch.cuda.get_device_name(0)

    def event_time(fn):
        """(output, ms) of the second of two calls, timed with CUDA
        events; the first warms the allocator and the caches."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def plain_ref(matrix, data):
        return gf_swar.gf_matmul_plain(gf_swar.coeff_from_reference(matrix),
                                       data)

    resident = []
    checked = 0
    # gf_swar_u8's launches of this phase by coefficient form
    u8_forms = {"constants": 0, "run-time": 0}

    def u8_form_checked(matrix, fn):
        """``fn()``, failing unless each gf_swar_u8 launch in it took the
        compile-time form for the RS(10,4) parity and the run-time form
        for any other matrix."""
        launches = gf_swar_u8.LAUNCHES.value
        rs = gf_swar_u8.RS10X4_LAUNCHES.value
        out = fn()
        launches = gf_swar_u8.LAUNCHES.value - launches
        rs = gf_swar_u8.RS10X4_LAUNCHES.value - rs
        parity = np.array_equal(matrix, parity10)
        check(rs == (launches if parity else 0),
              f"{rs} of {launches} gf_swar_u8 launches for "
              f"{'the RS(10,4) parity' if parity else 'another matrix'} took "
              "the compile-time form")
        u8_forms["constants"] += rs
        u8_forms["run-time"] += launches - rs
        return out

    def route(label, matrix, data, want, method):
        """One route of gf_matmul_fused on a tensor on the card: checked
        byte for byte against ``want`` (the plain version on the card) and
        timed with CUDA events."""
        nonlocal checked
        got, ms = u8_form_checked(matrix, lambda: event_time(
            lambda: gf_kernel.gf_matmul_fused(matrix, data, method=method)))
        torch.cuda.synchronize()
        check(got.device == data.device and got.dtype == data.dtype,
              f"{label} {method}: output kind {got.device} {got.dtype} is "
              f"not the input's")
        cmp = got.view(torch.uint8) if got.dtype != torch.uint8 else got
        diff = 0 if torch.equal(cmp, want) else int((cmp != want).sum())
        check(diff == 0, f"{label} method={method}: {diff} bytes differ "
                         "from the plain version")
        checked += 1
        in_bytes = data.numel() * data.element_size()
        row = {"case": label, "method": method or "None", "ms": ms,
               "input_GBps": in_bytes / ms / 1e6}
        resident.append(row)
        say(f"device-resident {label} method={method}: {ms:.4f} ms, "
            f"{row['input_GBps']:.1f} GB/s in; matches plain")
        return got

    def say_autotune(o, k):
        choice = autotune.best(o, k, kind="dev8")
        times = autotune.measured_times(o, k, "dev8")
        say(f"autotune dev8 {o}x{k} on {card} ({smi}): chose "
            f"{choice.method}/{choice.tile_n}; candidates at [{k},"
            f"{autotune.MEASURE_SHARD_BYTES // MIB}MiB], ms: " + ", ".join(
                f"{key} {ms:.4f}" for key, ms in sorted(
                    times.items(), key=lambda kv: kv[1])))
        return choice

    reset_counts()
    t7 = time.perf_counter()
    methods = (None, "repack", "swar", "mxu", "vpu")
    parity10 = gf256.parity_matrix(10, 4)
    slab = rand(10, 64 * MIB)
    want_p = plain_ref(parity10, slab)
    want_r = plain_ref(rec_matrix, slab)
    # the first method=None call has the autotuner measure live
    first = u8_form_checked(
        parity10, lambda: gf_kernel.gf_matmul_fused(parity10, slab))
    check(torch.equal(first, want_p), "the autotuned slab differs from plain")
    del first
    dev8_choice = say_autotune(4, 10)
    for method in methods:
        got = route("slab [10,64MiB] parity", parity10, slab, want_p, method)
        if method == "mxu":  # and against the bit-plane's own plain version
            agree("gf_bitplane", got, torch.cat([
                gf_bitplane.gf_matmul_plain(parity10, slab[:, i:i + chunk])
                for i in range(0, slab.shape[1], chunk)], dim=1),
                "slab [10,64MiB] parity")
        route("slab [10,64MiB] rebuild {0,5,11,13}", rec_matrix, slab,
              want_r, method)
    route("slab [10,16Mi] u32 parity", parity10, slab.view(torch.int32),
          want_p, None)
    route("slab [10,16Mi] u32 parity", parity10, slab.view(torch.int32),
          want_p, "swar")
    del slab, want_p, want_r, got

    for k, m in ((6, 3), (12, 4), (20, 4)):
        coeff = gf256.parity_matrix(k, m)
        x = rand(k, 32 * MIB)
        want = plain_ref(coeff, x)
        # measures live for this shape
        u8_form_checked(coeff, lambda: say_autotune(m, k))
        for method in methods:
            route(f"sweep RS({k},{m}) [{k},32MiB]", coeff, x, want, method)
        del x, want

    batch = rand(8, 10, 64 * MIB)
    want_b = plain_ref(parity10, batch)
    for method in methods:
        route("batch [8,10,64MiB]", parity10, batch, want_b, method)
    lane = batch.permute(1, 0, 2).reshape(10, 8 * 64 * MIB)
    want_lane = want_b.permute(1, 0, 2).reshape(4, 8 * 64 * MIB)
    del batch, want_b
    for method in methods:
        route("lane-packed [10,8x64MiB]", parity10, lane, want_lane, method)
    del lane, want_lane
    # the vpu route on a host array: to the card and back as numpy
    host = np.random.default_rng(args.seed).integers(
        0, 256, (10, 8 * MIB), dtype=np.uint8)
    got = gf_kernel.gf_matmul_fused(parity10, host, method="vpu")
    check(isinstance(got, np.ndarray) and got.shape == (4, 8 * MIB),
          "the host vpu route did not return numpy [4, 8 MiB]")
    check(np.array_equal(got, plain_ref(
        parity10, torch.from_numpy(host).to(dev)).cpu().numpy()),
        "the host vpu route differs from the plain version")
    checked += 1
    say("device-resident host [10,8MiB] method=vpu: numpy back, matches "
        "plain")
    torch.cuda.synchronize()
    path_launches["device_resident"] = {name: c.value
                                        for name, c in counters.items()}
    say(f"device-resident path: {checked} outputs match the plain versions "
        f"in {time.perf_counter() - t7:.1f} s; launches " + " ".join(
            f"{name}={n}" for name, n in
            path_launches["device_resident"].items()))
    check_path("device_resident")
    u8_launches = path_launches["device_resident"]["gf_swar_u8"]
    check(sum(u8_forms.values()) == u8_launches and all(u8_forms.values()),
          f"phase 7's gf_swar_u8 launches by form {u8_forms} do not account "
          f"for its {u8_launches} launches in both forms")
    say(f"gf_swar_u8 in the device-resident path: {u8_launches} launches, "
        f"{u8_forms['constants']} in the compile-time form (every RS(10,4) "
        f"parity launch), {u8_forms['run-time']} in the run-time form (the "
        "reconstructions and the other RS shapes)")
    say(json.dumps({"device_resident": resident,
                    "autotune_dev8_4x10": {
                        "method": dev8_choice.method,
                        "tile_n": dev8_choice.tile_n,
                        "candidates_ms": autotune.measured_times(
                            4, 10, "dev8")}}))

    # -- 8. the sweeps at their full default sizes --------------------------
    from seaweedfs_tpu_torch.tools import exp_batched, exp_dev8, exp_dev8b

    reset_counts()
    t8 = time.perf_counter()
    sweeps = {}
    for mod in (exp_dev8, exp_dev8b, exp_batched):
        name = mod.__name__.rsplit(".", 1)[1]
        sweeps[name] = mod.main(device=dev, seed=args.seed)
        for row in sweeps[name]:
            check(row["exact"], f"{name} row {row['label']!r} differs from "
                                "the plain version")
    torch.cuda.synchronize()
    path_launches["sweeps"] = {name: c.value for name, c in counters.items()}
    say(f"sweeps: {sum(len(r) for r in sweeps.values())} rows byte-exact in "
        f"{time.perf_counter() - t8:.1f} s; launches " + " ".join(
            f"{name}={n}" for name, n in path_launches["sweeps"].items()))
    check_path("sweeps")
    say(json.dumps({"sweeps": sweeps, "card": smi}))

    # -- 9. multi-volume encode ---------------------------------------------
    batch_dir = tempfile.mkdtemp(prefix="chip_smoke-batch-", dir=args.workdir)
    try:
        sizes = ([args.batch_volume_mib * MIB] * args.batch_volumes
                 + [64 * MIB + 12345])
        bases = [os.path.join(batch_dir, str(i + 1))
                 for i in range(len(sizes))]
        t0 = time.perf_counter()
        for i, (b, size) in enumerate(zip(bases, sizes)):
            make_volume(b, size, args.seed + 1 + i)
        say(f"batch volumes: {len(sizes)} of {sizes} bytes from seed "
            f"{args.seed + 1}.. in {time.perf_counter() - t0:.2f} s")
        # one parity dispatch per lane-packed chunk of each size group, a
        # kernel launch where the chunk is at least the codec's floor
        rs = RSCodec(C.DATA_SHARDS, C.PARITY_SHARDS, device=dev,
                     link_aware=False)
        floor = rs.device_min_bytes
        want_launches, want_host = map(sum, zip(*(
            routes(encode_widths(size, volumes=sizes.count(size)), floor)
            for size in set(sizes))))
        per_volume = sum(
            sum(-(-bs // encoder.choose_pipeline(size)[0])
                for _, bs in layout.encode_row_plan(size))
            for size in sizes)
        reset_counts()
        pt = PhaseTimer("ec.encode.batch")
        t0 = time.perf_counter()
        out = encoder.write_ec_files_batch(bases, phases=pt, rs=rs)
        batch_s = time.perf_counter() - t0
        summary = pt.summary()
        torch.cuda.synchronize()
        path_launches["batch_encode"] = {name: c.value
                                         for name, c in counters.items()}
        check_path("batch_encode")
        launches = path_launches["batch_encode"]["gf_swar"]
        host = path_launches["batch_encode"]["codec_host"]
        check((launches, host) == (want_launches, want_host),
              f"batch encode made {launches} kernel launches and {host} "
              f"host dispatches; its lane-packed chunks route to "
              f"{want_launches} and {want_host}")
        check(path_launches["batch_encode"]["gf_swar_rs10x4"] == launches,
              f"batch encode launched "
              f"{path_launches['batch_encode']['gf_swar_rs10x4']} of "
              f"{launches} parity kernels in the compile-time form")
        check(sorted(out) == sorted(bases), "batch encode returned other "
                                            "volumes")
        hashes = {b: [sha256_file(p) for p in out[b]] for b in bases}
        # each volume alone through write_ec_files, from a hard link
        single_dir = os.path.join(batch_dir, "single")
        os.mkdir(single_dir)
        single_s = 0.0
        for b in bases:
            s_base = os.path.join(single_dir, os.path.basename(b))
            os.link(b + ".dat", s_base + ".dat")
            t0 = time.perf_counter()
            paths = encoder.write_ec_files(s_base, rs=rs)
            single_s += time.perf_counter() - t0
            for i, p in enumerate(paths):
                check(sha256_file(p) == hashes[b][i],
                      f"batch shard {C.to_ext(i)} of volume {b} differs "
                      "from write_ec_files")
        # the batch once more, after the one-by-one pass, for the spread
        t0 = time.perf_counter()
        encoder.write_ec_files_batch(bases, rs=rs)
        batch2_s = time.perf_counter() - t0
        total_bytes = sum(sizes)
        phases = summary["phases"]
        batch_row = {
            "volumes": len(sizes), "dat_bytes": total_bytes,
            "seconds": batch_s, "GBps": total_bytes / batch_s / 1e9,
            "seconds_again": batch2_s,
            "GBps_again": total_bytes / batch2_s / 1e9,
            "parity_launches": launches, "launches_one_per_volume":
                per_volume,
            "single_seconds": single_s,
            "single_GBps": total_bytes / single_s / 1e9,
            "phases": {p: phases[p]["seconds"] for p in phases},
            "notes": summary.get("notes", {}),
        }
        say(f"batch encode of {len(sizes)} volumes ({total_bytes} bytes, "
            f"two size groups): {batch_s:.3f} s = {batch_row['GBps']:.3f} "
            f"GB/s, {launches} parity launches (one per lane-packed chunk, "
            "all in the compile-time RS(10,4) form; "
            f"{per_volume} one volume at a time); 14 x {len(sizes)} shard "
            f"files hash equal to write_ec_files ({single_s:.3f} s = "
            f"{batch_row['single_GBps']:.3f} GB/s one by one); the batch "
            f"again after them: {batch2_s:.3f} s = "
            f"{batch_row['GBps_again']:.3f} GB/s")
        say("batch encode phases (busy s): " + " ".join(
            f"{p}={phases[p]['seconds']:.3f}"
            for p in ("read", "stage", "h2d", "codec", "write", "flush")
            if p in phases
        ) + f" wall={summary['wall_seconds']:.3f} "
            f"notes={json.dumps(summary.get('notes', {}))}")
        say(json.dumps({"batch_encode": batch_row}))
    finally:
        shutil.rmtree(batch_dir, ignore_errors=True)

    # -- 10. the EC read path and ec.decode ---------------------------------
    read_row, path_launches["read_decode"] = phase_read_decode(
        args, torch, dev, agree, reset_counts, counters)
    check_path("read_decode")
    say(json.dumps({"read_decode": read_row, "card": smi}))

    # -- 11. routing and observability --------------------------------------
    routing_row, path_launches["routing"] = phase_routing(
        args, torch, dev, smi, volume_hashes, reset_counts, counters)
    check_path("routing")
    say(json.dumps({"routing": routing_row}))

    kernels = []
    for name, (_, source, replaces, *also) in KERNELS.items():
        row = timings[name][0]
        by_path = {path: counts[name] for path, counts in path_launches.items()}
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "also_replaces": also,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": stats[name]["worst"],
            "bytes_differing_vs_plain": stats[name]["differing"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"],
            "timings": timings[name],
        }
        if name == "gf_swar":
            entry.update(
                launches_rs10x4_by_path={
                    path: counts["gf_swar_rs10x4"]
                    for path, counts in path_launches.items()},
                launches_encode=enc_launches,
                launches_rebuild=[r[2] for r in rebuilds],
                encode_GBps=gbps,
                rebuild_GBps=rebuild_gbps,
            )
        if name == "gf_swar_u8":
            entry.update(
                launches_rs10x4_by_path={
                    path: counts["gf_swar_u8_rs10x4"]
                    for path, counts in path_launches.items()},
                launches_device_resident_by_form=u8_forms,
            )
        kernels.append(entry)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
