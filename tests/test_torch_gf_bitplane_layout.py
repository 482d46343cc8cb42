"""A numpy model of one warp of gf_bitplane's kernel (``csrc/gf_bitplane.cu``).

The kernel's lane mapping cannot run here: it is CUDA. This model builds
what each of the 32 lanes holds, step by step as the kernel does it, and
holds the bytes the lanes store to the plain version and to the
reference's GF(2^8) product:

- the words a lane loads: lane (g, tig) reads, for K slice ks, the u32 of
  input row 4ks + tig at columns 4g .. 4g + 3 of the 32-column chunk
  (0 past k rows or past n columns);
- its B fragments: byte t of the word broadcast and masked, bits 0..3 to
  register b0 and bits 4..7 to b1 (each bit kept in place);
- its A fragments, as ``fragment_bitmatrix`` cuts them;
- mma.m16n8k32 .s8.s8.s32 by the PTX fragment layout: A register r of lane
  (g, tig) holds row g + 8(r & 1), K columns 16(r >> 1) + 4tig .. +3; B
  register r' holds K rows 16r' + 4tig .. +3 of column g; sum register r
  holds row g + 8(r >> 1), column 2tig + (r & 1);
- the pack: byte 0 of four sums gathered with the kernel's byte
  permutations, shifted into place, the one exchange with lane ^ 16 at
  MT = 2, and the words each lane stores.

Tolerance 0: GF(2^8) arithmetic is exact.
"""

import ctypes
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from seaweedfs_tpu.ops import bitmatrix as ref_bitmatrix  # noqa: E402
from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import build, gf_bitplane  # noqa: E402

LANES = np.arange(32)
G, TIG = LANES >> 2, LANES & 3
CHUNK = 32


def byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on uint32 arrays."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def lane_words(data, k, n):
    """[chunks, 32 lanes, KS] uint32: the word each lane loads per K slice."""
    ks_n = -(-k // 4)
    chunks = -(-n // CHUNK)
    padded = np.zeros((4 * ks_n, chunks * CHUNK + 4), np.uint32)
    padded[:k, :n] = data
    c = np.arange(chunks)[:, None, None]
    ks = np.arange(ks_n)[None, None, :]
    row = 4 * ks + TIG[None, :, None]
    col = CHUNK * c + 4 * G[None, :, None]
    return sum(padded[row, col + i] << (8 * i) for i in range(4))


def b_fragments(words):
    """[chunks, 32, KS, 4 n-tiles, 2 registers] uint32."""
    out = np.empty(words.shape + (4, 2), np.uint32)
    for t in range(4):
        v = byte_perm(words, np.uint32(0), 0x1111 * t)
        out[..., t, 0] = v & 0x08040201
        out[..., t, 1] = v & 0x80402010
    return out


def s8(words, i):
    return ((words >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)


def warp_sums(a_regs, b_regs):
    """[chunks, 32 lanes, MT, 4 n-tiles, 4 registers] int32."""
    mt_n, ks_n = a_regs.shape[:2]
    a = np.zeros((mt_n, ks_n, 16, 32), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for r in range(4):
            for i in range(4):
                a[:, :, g + 8 * (r & 1), 16 * (r >> 1) + 4 * tig + i] = s8(
                    a_regs[:, :, lane, r], i)
    chunks = b_regs.shape[0]
    b = np.zeros((chunks, ks_n, 4, 32, 8), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for r in range(2):
            for i in range(4):
                b[:, :, :, 16 * r + 4 * tig + i, g] = s8(
                    b_regs[:, lane, :, :, r], i)
    # D[c, mt, t, row, col] = sum over ks and K of A[mt, ks, row, K] B[c,
    # ks, t, K, col]
    d = np.einsum("mkrq,cktqn->cmtrn", a, b)
    assert np.abs(d).max(initial=0) < 2 ** 31
    acc = np.empty((chunks, 32, mt_n, 4, 4), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for r in range(4):
            acc[:, lane, :, :, r] = d[:, :, :, g + 8 * (r >> 1),
                                      2 * tig + (r & 1)]
    return acc.astype(np.int32)


def gather0(a0, a1, a2, a3):
    u = [np.asarray(a, np.int32).view(np.uint32) for a in (a0, a1, a2, a3)]
    lo = byte_perm(u[0], u[1], 0x0040)
    hi = byte_perm(u[2], u[3], 0x0040)
    return byte_perm(lo, hi, 0x5410)


def warp_stores(acc):
    """[(row [chunks, 32], column in the chunk [chunks, 32], word [chunks,
    32])] of every store of the pack."""
    mt_n = acc.shape[2]
    g, tig = G[None, :], TIG[None, :]
    stores = []
    if mt_n == 2:
        nib = g >> 2
        half = []
        for e in range(2):
            v = np.zeros(acc.shape[:2], np.uint32)
            for q in range(4):
                mt, r = q >> 1, 2 * (q & 1) + e
                v |= gather0(*(acc[:, :, mt, t, r] for t in range(4))) >> (
                    7 - q)
            half.append(v)
        keep = np.where(nib == 1, half[1], half[0]) << (4 * nib)
        send = np.where(nib == 1, half[0], half[1]) << (4 * nib)
        recv = send[:, LANES ^ 16]  # __shfl_xor_sync(..., 16)
        stores.append((np.broadcast_to(g & 3, keep.shape),
                       np.broadcast_to(8 * tig + 4 * nib, keep.shape),
                       keep | recv))
    else:
        for u in range(mt_n // 4):
            for e in range(2):
                v = np.zeros(acc.shape[:2], np.uint32)
                for bit in range(8):
                    mt, r = 4 * u + (bit >> 1), 2 * (bit & 1) + e
                    v |= gather0(*(acc[:, :, mt, t, r] for t in range(4))) >> (
                        7 - bit)
                stores.append((np.broadcast_to(g + 8 * u, v.shape),
                               np.broadcast_to(8 * tig + 4 * e, v.shape), v))
    return stores


def warp_model(coeff, data):
    """The bytes the kernel's lanes store for ``coeff`` over ``data`` [k,
    n]: [o, n] uint8, every byte written exactly once."""
    o, k = coeff.shape
    n = data.shape[1]
    frags = gf_bitplane.fragment_bitmatrix(coeff)
    a_regs = np.ascontiguousarray(frags).view(np.uint32)[..., 0]
    acc = warp_sums(a_regs, b_fragments(lane_words(data, k, n)))
    out = np.zeros((o, n), np.uint8)
    written = np.zeros((o, n), np.int64)
    chunk0 = CHUNK * np.arange(acc.shape[0])[:, None]
    for row, col, word in warp_stores(acc):
        for i in range(4):
            c = chunk0 + col + i
            live = (row < o) & (c < n)
            out[row[live], c[live]] = (word[live] >> (8 * i)) & 0xFF
            np.add.at(written, (row[live], c[live]), 1)
    assert (written == 1).all(), "a byte stored twice or never"
    return out


def expected_a(coeff):
    """A [MT, 16, KS, 32] in the order this model assumes, written out
    from expand_bitmatrix: row g + 8h of m-tile mt is bit 4(g >> 2) + 2mt
    + h of output g & 3 at MT = 2, bit q & 7 of output g + 8(q >> 3) (q =
    2mt + h) at MT = 4 and 8; column kappa of slice ks is bit (kappa & 3)
    + 4(kappa >> 4) of input 4ks + ((kappa & 15) >> 2), weighed by
    2^(7 - bit) as an int8."""
    o, k = coeff.shape
    bits = ref_bitmatrix.expand_bitmatrix(coeff)
    mt_n = 2 if o <= 4 else 4 if o <= 8 else 8
    ks_n = -(-k // 4)
    a = np.zeros((mt_n, 16, ks_n, 32), np.int64)
    for mt, rho, ks, kappa in np.ndindex(a.shape):
        g, h = rho & 7, rho >> 3
        if mt_n == 2:
            out, bit = g & 3, 4 * (g >> 2) + 2 * mt + h
        else:
            q = 2 * mt + h
            out, bit = g + 8 * (q >> 3), q & 7
        d, j = 4 * ks + ((kappa & 15) >> 2), (kappa & 3) + 4 * (kappa >> 4)
        if out < o and d < k:
            a[mt, rho, ks, kappa] = bits[8 * out + bit, 8 * d + j] << (7 - j)
    return a.astype(np.uint8).view(np.int8)


def rebuild_matrix(lost):
    present = [i for i in range(14) if i not in lost]
    return ref_gf256.reconstruction_matrix(10, 4, present)[0]


MATRICES = {
    "RS(10,4) parity": lambda: ref_gf256.parity_matrix(10, 4),
    "RS(6,3) parity": lambda: ref_gf256.parity_matrix(6, 3),
    "RS(20,4) parity": lambda: ref_gf256.parity_matrix(20, 4),
    "rebuild {0,5,11,13}": lambda: rebuild_matrix((0, 5, 11, 13)),
}


def check(coeff, n, seed):
    data = np.random.default_rng(seed).integers(
        0, 256, (coeff.shape[1], n), dtype=np.uint8)
    got = warp_model(coeff, data)
    want = gf_bitplane.gf_matmul_plain(coeff, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_gf256.gf_matmul_cpu(coeff, data))


# widths that are no multiple of a span of 2 or 4 chunks, nor of a chunk
@pytest.mark.parametrize("n", [1, 165, 1000])
@pytest.mark.parametrize("name", list(MATRICES))
def test_warp_model_matches_plain(name, n):
    check(MATRICES[name](), n, seed=n)


@pytest.mark.parametrize("o", range(1, 17))
def test_warp_model_every_output_count_at_k64(o):
    coeff = np.random.default_rng(o).integers(0, 256, (o, 64), dtype=np.uint8)
    check(coeff, 165, seed=100 + o)


@pytest.mark.parametrize("o,k", [(3, 10), (4, 10), (6, 7), (9, 20), (16, 64),
                                 (1, 1)])
def test_fragment_order_is_the_models(o, k):
    coeff = np.random.default_rng(o * 100 + k).integers(
        0, 256, (o, k), dtype=np.uint8)
    frags = gf_bitplane.fragment_bitmatrix(coeff)
    a = expected_a(coeff)
    mt_n, ks_n = a.shape[0], a.shape[2]
    assert frags.shape == (mt_n, ks_n, 32, 4, 4) and frags.dtype == np.int8
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for r in range(4):
            for i in range(4):
                np.testing.assert_array_equal(
                    frags[:, :, lane, r, i],
                    a[:, g + 8 * (r & 1), :, 16 * (r >> 1) + 4 * tig + i])


def test_sums_carry_the_parity_in_bit_7_alone():
    """Every product is 0 or +-128, so byte 0 of a sum is 0x00 or 0x80 and
    the gather needs no mask."""
    coeff = rebuild_matrix((0, 5, 11, 13))
    data = np.random.default_rng(7).integers(0, 256, (10, 96), dtype=np.uint8)
    frags = gf_bitplane.fragment_bitmatrix(coeff)
    acc = warp_sums(np.ascontiguousarray(frags).view(np.uint32)[..., 0],
                    b_fragments(lane_words(data, 10, 96)))
    assert set(np.unique(acc & 0xFF)) <= {0, 0x80}
    assert (acc % 128 == 0).all()


def _c_signature(source: str, fn: str) -> list[str]:
    """The parameter types of C function ``fn`` in ``source``."""
    m = re.search(rf"int {fn}\((.*?)\)\s*\{{", source, re.S)
    assert m, f"no {fn} in the source"
    return [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0]
            + ("*" if "*" in p.rsplit(" ", 1)[-1] else "")
            for p in m.group(1).split(",")]


def test_launcher_signature_matches_the_wrapper():
    """The ctypes argument list the wrapper declares is the C launcher's,
    type by type."""
    with open(os.path.join(build.CSRC, "gf_bitplane.cu")) as f:
        params = _c_signature(f.read(), "gf_bitplane_launch")
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    assert gf_bitplane.LAUNCH_ARGTYPES == [ctype[p] for p in params]


# chip_smoke's phase 1 counts gf_bitplane's instructions a chunk in its SASS;
# a synthetic listing in cuobjdump's form checks what each scope takes in
_CHUNK_BODY = [
    "IMMA.16832.S8.S8 R16, R4, R8, R16", "IMMA.16832.S8.S8 R20, R4, R9, R20",
    "IMMA.16832.S8.S8 R24, R4, R10, R24", "IMMA.16832.S8.S8 R28, R4, R11, R28",
    "PRMT R5, R2, 0x1111, RZ", "LOP3.LUT R6, R5, 0x8040201, RZ, 0xc0, !PT",
    "LOP3.LUT R7, R5.reuse, 0x80402010, RZ, 0xc0, !PT",
    "PRMT R8, R9, 0x40, R10", "PRMT R8, R9, 0x5410, R10",
    "SHF.R.U32.HI R11, RZ, 0x4, R8", "LOP3.LUT R12, R11, R13, R14, 0xfe, !PT",
    "ISETP.GE.AND P1, PT, R1, R2, PT", "IMAD R3, R1, R2, RZ",
]


def _listing(body_forms=_CHUNK_BODY):
    """Set-up, a whole-span loop of two chunk bodies closed by a predicated
    backward branch, a masked chunk body, and an out-of-line block whose
    unpredicated branch jumps back into the loop."""
    ins = ["IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28]", "S2R R0, SR_TID.X"]
    loop = len(ins)
    ins += body_forms + body_forms + ["IADD3 R1, R1, 0x1, RZ",
                                      "ISETP.GE.AND P0, PT, R1, R3, PT",
                                      f"@!P0 BRA 0x{16 * loop:x}"]
    ins += body_forms + ["EXIT", f"BRA 0x{16 * (loop + 3):x}"]
    return "\n".join(f"        /*{16 * i:04x}*/                   {t} ;"
                     for i, t in enumerate(ins))


@pytest.fixture
def chip_smoke():
    import chip_smoke
    return chip_smoke


def test_bitplane_counts_by_scope(chip_smoke, monkeypatch):
    """forms: the seven unpack and pack forms over the three chunk bodies;
    loop: every ALU and FMA instruction of the predicated backward branch's
    range over its two chunks; function: all of them over three bodies."""
    monkeypatch.setattr(chip_smoke, "sass_body", lambda *a: _listing())
    forms, counts = chip_smoke.bitplane_counts("nvcc", "lib", "sym", 1, 1, 4)
    assert forms == {name: 3 for name in chip_smoke.BITPLANE_FORMS}
    assert counts["forms"] == (7.0, 0.0)
    assert counts["loop"] == (9.0, 1.0)
    assert counts["function"] == pytest.approx((26 / 3, 4 / 3))
    # four chunks of 8 instructions on one pipe, 32 lanes each
    assert chip_smoke.chunk_ms(8.0, 1.0, 4 * 32) == pytest.approx(
        1e3 * 32 * 4 * 8 / chip_smoke.INT_PIPE_OPS_PER_S)


def test_bitplane_counts_fail_on_a_form_that_matches_nothing(chip_smoke,
                                                            monkeypatch):
    """A form the compiler spells otherwise must fail phase 1, not read as a
    lower count."""
    body = [t for t in _CHUNK_BODY if not t.endswith("0xfe, !PT")]
    monkeypatch.setattr(chip_smoke, "sass_body", lambda *a: _listing(body))
    with pytest.raises(AssertionError, match="LOP3 OR"):
        chip_smoke.bitplane_counts("nvcc", "lib", "sym", 1, 1, 4)
