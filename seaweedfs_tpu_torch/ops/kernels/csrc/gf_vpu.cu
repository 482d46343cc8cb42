// GF(2^8)/0x11d matrix product by split product tables applied with byte
// permutes, four shard bytes a register, for Hopper (sm_90a).
//
//   out[b, i, c] = XOR_d  C[i, d] ∘GF in[b, d, c]      i < O, d < k, c < n
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py _vpu_kernel
// (with _xtime), built by _build_call for method "vpu". The TPU's vector
// unit has no byte lanes, so the reference holds each byte alone in an
// int32 lane and doubles it through every coefficient bit. Hopper's PRMT
// (__byte_perm) has byte lanes: it picks four bytes out of eight by four
// 3-bit selectors. Here those byte lanes do the products, as table
// lookups, so the TPU's int32 lanes became PRMT's byte lanes.
//
// What bound the first design on an H100 SXM: it copied the reference's
// layout, one byte per 32-bit register, and per column of an RS(10,4)
// parity product (14 bytes of traffic) did 60 doublings (2 ALU-pipe and
// 2 FMA-pipe instructions each) and 156 predicated XORs, one a set
// coefficient bit: 276 ALU-pipe operations, some 20 a byte where the
// card's balance is 5, so it ran at 3-4 times its bytes' time.
//
// The design. The product is linear over the bits of x, so with x cut
// into three pieces,
//   c·x = L0[x & 7] ^ L1[(x >> 3) & 7] ^ L2[x >> 6],
//   L0[v] = c·v, L1[v] = c·(v << 3), L2[v] = c·(v << 6),
// three tables of eight, eight and four bytes (five registers) a
// coefficient. Every coefficient, 0 and 1 included, costs the same: no
// run-time trip count, no predicated XOR, reconstruction matrices cost
// what the parity costs.
//
// - Selectors, once per input word pair and shared by every output: for
//   words a and b (eight columns), selector register Sp holds in byte j
//   piece p of a's byte j in its low nibble and of b's byte j in its high
//   nibble (bit 3 of each nibble clear, so PRMT never replicates a sign).
//   PRMT reads a selector's low 16 bits: Sp picks for columns a0 b0 a1 b1,
//   Sp >> 16 for a2 b2 a3 b3. About 6 ALU-pipe instructions a word.
// - Per coefficient and word pair half: three PRMTs, one per table, and
//   their XOR into the output's accumulator. Rows go two at a time, so
//   ptxas folds the six lookups of a half into three three-input LOP3s:
//   4.5 ALU-pipe instructions a word a coefficient.
// - At the end two PRMTs a word pair put the interleaved columns back.
// Counted for RS(10,4): 10 x (6 + 4 x 4.5) + 4 = 244 ALU-pipe
// instructions a u32 word of all four outputs (56 bytes of traffic), 0.24
// ms of issue at [10, 64 MiB] against 0.2805 ms of HBM3 bytes, where the
// first design needed 4 x 276 = 1104.
//
// The tables are built on the card: the launcher turns the SwarCoeff
// masks into the o x k matrix (VpuCoeff, a grid constant); each block
// builds its 20 bytes a coefficient into shared memory (1,280 bytes for
// RS(10,4), 20 KiB at O = 16, k = 64), one coefficient a thread, and
// loops over several column tiles so the build is paid once. A warp
// reads a coefficient's tables as same-address broadcasts (one LDS.128
// and one LDS.32) and applies them to all four words it holds.
//
// Bytes in flight: a thread takes 16 bytes of each row (four words, one
// 16-byte load where the rows are whole and aligned, else gf_common.cuh's
// load_bytes), neighbouring threads neighbouring 16 bytes, and loads rows
// d + 2 and d + 3 while it computes rows d and d + 1. Up to four outputs,
// ptxas is held to three blocks of 256 threads an SM (min_blocks).
//
// Rows are taken as they lie: any width (the ragged tail is read and
// written byte by byte with a mask) and any row and batch stride, so the
// route makes no padding copy and a batch stays a grid axis. Limits:
// O <= 16, k <= 64, batch <= 65535. The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "gf_common.cuh"

namespace {

constexpr int kBytes = 16;          // bytes a thread takes from each row
constexpr int kMaxTilesPerBlock = 8;

// The matrix itself, C[i][d] at c[d][i], as the kernel's grid constant.
struct VpuCoeff {
  uint8_t c[kMaxIn][kMaxOut];
};

// c·v for each of the four bytes of v (SWAR doublings of v through the
// bits of c): one table word.
__device__ __forceinline__ uint32_t gf_scale(uint32_t c, uint32_t v) {
  uint32_t acc = 0u;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((c >> b) & 1u) acc ^= v;
    v = xtime(v);
  }
  return acc;
}

// The three selectors of word pair (a, b) and their upper halves:
// s[0..2] pick for columns a0 b0 a1 b1, s[3..5] for a2 b2 a3 b3.
__device__ __forceinline__ void selectors(uint32_t a, uint32_t b,
                                          uint32_t (&s)[6]) {
  s[0] = (a & 0x07070707u) | ((b & 0x07070707u) << 4);
  s[1] = ((a >> 3) & 0x07070707u) | ((b << 1) & 0x70707070u);
  s[2] = ((a >> 6) & 0x03030303u) | ((b >> 2) & 0x30303030u);
  s[3] = s[0] >> 16;
  s[4] = s[1] >> 16;
  s[5] = s[2] >> 16;
}

// c·x for the four columns selector set s (offset h: 0 or 3) picks, from
// c's tables: t = {L0 bytes 0-3, L0 4-7, L1 0-3, L1 4-7}, t2 = L2.
__device__ __forceinline__ uint32_t lookup(const uint4& t, uint32_t t2,
                                           const uint32_t (&s)[6], int h) {
  return __byte_perm(t.x, t.y, s[h]) ^ __byte_perm(t.z, t.w, s[h + 1]) ^
         __byte_perm(t2, 0u, s[h + 2]);
}

// Row d's 16 bytes at this thread's column as four words (0 past the row).
template <bool kWhole>
__device__ __forceinline__ void load_row(const uint8_t* p, long long avail,
                                         bool vec, uint32_t (&w)[4]) {
  if constexpr (kWhole) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    load_bytes<kBytes>(p, avail, vec, w);
  }
}

// acc[i][q][h] ^= C[i, d] ∘GF rows d and d + 1 for word pair q, half h;
// row d + 1 past k is all zero words, whose lookups give c·0 = 0.
template <int O, bool kWhole>
__device__ __forceinline__ void column(const uint8_t* src, long long rs,
                                       long long avail, bool vec, int k,
                                       const uint4* tab, const uint32_t* tab2,
                                       uint32_t (&acc)[O][2][2]) {
  uint32_t x[2][4], nx[2][4];
  load_row<kWhole>(src, avail, vec, x[0]);
  if (k > 1) {
    load_row<kWhole>(src + rs, avail, vec, x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[1][j] = 0u;
  }
  for (int d = 0; d < k; d += 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (d + 2 + r < k) {
        load_row<kWhole>(src + (d + 2 + r) * rs, avail, vec, nx[r]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) nx[r][j] = 0u;
      }
    }
    uint32_t s[2][2][6];  // row, word pair, selector
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      selectors(x[r][0], x[r][1], s[r][0]);
      selectors(x[r][2], x[r][3], s[r][1]);
    }
    const int d1 = d + 1 < k ? d + 1 : d;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const uint4 t0 = tab[d * O + i];
      const uint32_t u0 = tab2[d * O + i];
      const uint4 t1 = tab[d1 * O + i];
      const uint32_t u1 = tab2[d1 * O + i];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[i][q][h] ^= lookup(t0, u0, s[0][q], 3 * h) ^
                          lookup(t1, u1, s[1][q], 3 * h);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[r][j] = nx[r][j];
    }
  }
}

// Blocks an SM ptxas must fit by registers: three up to four outputs (80
// registers, no spill; 0.348 against 0.376 ms at [10, 64 MiB] with the two
// its own choice of 92 allows, PERF.md), one above, where that cap spills.
__host__ __device__ constexpr int min_blocks(int o) { return o <= 4 ? 3 : 1; }

template <int O>
__global__ void __launch_bounds__(kThreads, min_blocks(O))
    gf_vpu_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int k, const Layout L, int tiles_per_block,
                  const __grid_constant__ VpuCoeff coeff) {
  // [k][O] tables: L0 and L1 as a uint4, then L2 as a word
  extern __shared__ uint4 smem[];
  uint4* tab = smem;
  uint32_t* tab2 = reinterpret_cast<uint32_t*>(smem + k * O);
  for (int p = threadIdx.x; p < k * O; p += kThreads) {
    const uint32_t c = coeff.c[p / O][p % O];
    tab[p] = make_uint4(gf_scale(c, 0x03020100u), gf_scale(c, 0x07060504u),
                        gf_scale(c, 0x18100800u), gf_scale(c, 0x38302820u));
    tab2[p] = gf_scale(c, 0xc0804000u);
  }
  __syncthreads();

  const uint8_t* src_b = in + blockIdx.y * L.in_bs;
  uint8_t* dst_b = out + blockIdx.y * L.out_bs;
  for (int t = 0; t < tiles_per_block; ++t) {
    const long long col =
        ((static_cast<long long>(blockIdx.x) * tiles_per_block + t) *
             kThreads + threadIdx.x) * kBytes;
    if (col >= L.n) return;
    const long long avail = L.n - col;
    const bool whole = avail >= kBytes;
    uint32_t acc[O][2][2];
#pragma unroll
    for (int i = 0; i < O; ++i) {
      acc[i][0][0] = acc[i][0][1] = acc[i][1][0] = acc[i][1][1] = 0u;
    }
    if (whole && L.in_vec) {
      column<O, true>(src_b + col, L.in_rs, avail, true, k, tab, tab2, acc);
    } else {
      column<O, false>(src_b + col, L.in_rs, avail, L.in_vec, k, tab, tab2,
                       acc);
    }
#pragma unroll
    for (int i = 0; i < O; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        w[2 * q] = __byte_perm(acc[i][q][0], acc[i][q][1], 0x6420);
        w[2 * q + 1] = __byte_perm(acc[i][q][0], acc[i][q][1], 0x7531);
      }
      store_bytes<kBytes>(dst_b + i * L.out_rs + col, w, avail, L.out_vec);
    }
  }
}

}  // namespace

extern "C" {

int gf_vpu_coeff_bytes() { return static_cast<int>(sizeof(SwarCoeff)); }

const char* gf_vpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] with byte strides (in_bs, in_rs);
// out: device u8 [batch, o, >= n] with byte strides (out_bs, out_rs);
// coeff: host pointer to gf_vpu_coeff_bytes() bytes of SwarCoeff.
int gf_vpu_launch(const void* in, void* out, int o, int k, long long n,
                  int batch, long long in_bs, long long in_rs,
                  long long out_bs, long long out_rs, const void* coeff,
                  int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n < 0 || batch < 1 ||
      batch > 65535 || (n + kBytes - 1) / kBytes > 0x7fffffffLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L{n, in_bs, in_rs, out_bs, out_rs,
                 aligned(in, in_bs, in_rs, kBytes),
                 aligned(out, out_bs, out_rs, kBytes)};
  SwarCoeff masks;
  std::memcpy(&masks, coeff, sizeof(masks));
  VpuCoeff c{};
  for (int d = 0; d < k; ++d) {
    for (int b = 0; b < 8; ++b) {
      for (int i = 0; i < o; ++i) {
        c.c[d][i] |= static_cast<uint8_t>(((masks.mask[d][b] >> i) & 1u) << b);
      }
    }
  }
  // tiles of kThreads x 16 bytes; a block takes several, so its table
  // build is paid once, while the grid keeps 16 blocks an SM (0.347
  // against 0.363 ms at one tile a block at [10, 64 MiB], PERF.md)
  const long long tiles = (n + kThreads * kBytes - 1) / (kThreads * kBytes);
  long long per = tiles / (16LL * sms * batch);
  per = per < 1 ? 1 : (per > kMaxTilesPerBlock ? kMaxTilesPerBlock : per);
  const dim3 grid(static_cast<unsigned>((tiles + per - 1) / per),
                  static_cast<unsigned>(batch));
  const int per_block = static_cast<int>(per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch_out(o, [&](auto oc) {
    constexpr int O = decltype(oc)::value;
    const size_t smem = static_cast<size_t>(k) * O * (sizeof(uint4) + 4);
    gf_vpu_kernel<O><<<grid, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), k, L,
        per_block, c);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
