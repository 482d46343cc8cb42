// GF(2^8) matrix product by bit planes on the int8 tensor cores, for Hopper
// (sm_90a).
//
//   out[b, i, c] = pack_j( (sum_e B[i*8+j, e] * bits[b, e, c]) & 1 )
//   bits[b, d*8+j, c] = (in[b, d, c] >> j) & 1,   B = expand_bitmatrix(C)
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py _mxu_kernel
// with _unpack_bits and _pack_bits (built by _build_call, method "mxu"):
// multiplication by a GF(2^8) constant is linear over GF(2), so the whole
// coefficient matrix C[o, k] becomes a 0/1 matrix B[o*8, k*8] and the
// product an integer matrix product followed by a parity. The TPU kernel
// runs it on the MXU in bf16 with f32 sums; here it runs on the int8 tensor
// cores with int32 sums (mma.sync m16n8k32 .s8.s8.s32), exact: every
// product is 0 or +-128 and there are at most k*8 <= 512 of them.
//
// A warp works alone on chunks of 32 columns (4 n-tiles of 8), with no
// block barrier in its loop, and the bits never touch memory:
//   1. loads: the lane (g, tig) reads, for K slice ks, one u32 of input
//      row 4ks + tig at columns 4g .. 4g + 3, so every word is read once.
//      Whole spans of span_chunks chunks (every column inside n, rows
//      4-byte aligned) take straight-line loads and stores, chosen once
//      per warp; the words of the warp's next span load while it works on
//      this one. The masked byte path takes the rest;
//   2. unpack: K row 16r + 4tig + i of the slice is bit 4r + i of the
//      lane's row, so byte t of its word, broadcast (one byte permute) and
//      masked twice, is the B operand of n-tile t: each bit stays in place
//      (x & 2^j) and A weighs it by 2^(7-j), so every product is 0 or
//      +-128 and a sum's byte 0 is 0x00 or 0x80, its parity in bit 7;
//   3. product: A, cut by the wrapper into each lane's fragment
//      registers, comes from shared memory (one 16-byte load a fragment;
//      loaded once per block);
//   4. pack, in the lane: A's rows are ordered so that a lane's sums are
//      bits of whole output bytes. At MT = 2 (o <= 4) lanes g and g ^ 4
//      hold the two nibbles of one output at the same 8 columns; byte
//      permutes gather byte 0 of four sums, shifts put the bits in place,
//      and one __shfl_xor_sync trades half of them, leaving each lane 4
//      consecutive output bytes, one u32 store. At MT = 4 and 8 a lane
//      already holds whole bytes. No warp vote.
//
// What bounds it: the function is byte-bound (the int8 product is 2 * o*8
// * k*8 operations a column, 0.17 ms at [10, 64 MiB] against 0.28 ms of
// bytes on an H100). The design adds integer work, the byte permutes and
// masks of the unpack and the gathers of the pack, on the ALU pipe, and
// the loads' latency, which the spans keep in flight. Columns past n read
// as 0 and are not written, and rows may be strided, so the caller makes
// no padding copy.
//
// Layout: in [batch, k, >= n] and out [batch, o, >= n] u8 with byte strides;
// frags is the A operand, [MT][KS][32 lanes][4 u32] (fragment_bitmatrix in
// gf_bitplane.py), MT = 2, 4 or 8 m-tiles, KS = ceil(k / 4). Limits: o <= 16,
// k <= 64, batch <= 65535. The launcher allocates nothing, launches on the
// caller's stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOut = 16;
constexpr int kMaxIn = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;          // columns of one product: 4 n-tiles of 8
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  long long n;             // row width in bytes
  long long in_bs, in_rs;  // byte strides of the input batch and rows
  long long out_bs, out_rs;
  bool in_vec;             // input 4-byte aligned
  bool out_vec;            // output 4-byte aligned
};

__device__ __forceinline__ uint32_t load4(const uint8_t* p, long long avail,
                                          bool vec) {
  if (vec && avail >= 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0;
  for (int i = 0; i < 4 && i < avail; ++i) {
    w |= static_cast<uint32_t>(__ldg(p + i)) << (8 * i);
  }
  return w;
}

__device__ __forceinline__ void store4(uint8_t* p, uint32_t v,
                                       long long avail, bool vec) {
  if (vec && avail >= 4) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  for (int i = 0; i < 4 && i < avail; ++i) {
    p[i] = static_cast<uint8_t>(v >> (8 * i));
  }
}

// byte 0 of each of four sums, one to a byte
__device__ __forceinline__ uint32_t gather0(int a0, int a1, int a2, int a3) {
  const uint32_t lo = __byte_perm(static_cast<uint32_t>(a0),
                                  static_cast<uint32_t>(a1), 0x0040u);
  const uint32_t hi = __byte_perm(static_cast<uint32_t>(a2),
                                  static_cast<uint32_t>(a3), 0x0040u);
  return __byte_perm(lo, hi, 0x5410u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The B operand of n-tile t from the lane's word x (byte t = data column
// 4g + t of input row 4ks + tig): b0 holds K rows 4tig .. +3, bits 0..3 of
// the byte, b1 K rows 16 + 4tig .. +3, bits 4..7. Each bit stays in place
// (x & 2^j); the A operand weighs it by 2^(7-j).
__device__ __forceinline__ void unpack(uint32_t x, int t, uint32_t& b0,
                                       uint32_t& b1) {
  const uint32_t v = __byte_perm(x, 0u, 0x1111u * t);  // byte t, 4 times
  b0 = v & 0x08040201u;
  b1 = v & 0x80402010u;
}

// The sums of one chunk: acc[mt][t][r] of m-tile mt and n-tile t, from the
// lane's words w[ks]; reload(ks, w[ks]) runs once w[ks] is read.
template <int MT, int KSM, class Reload>
__device__ __forceinline__ void product(int (&acc)[MT][4][4],
                                        uint32_t (&w)[KSM], int ks_n,
                                        const uint4* sA, int lane,
                                        Reload reload) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][t][r] = 0;
    }
  }
#pragma unroll
  for (int ks = 0; ks < KSM; ++ks) {
    if (ks >= ks_n) break;
    const uint32_t x = w[ks];
    reload(ks, w[ks]);
    uint32_t b[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) unpack(x, t, b[t][0], b[t][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 a = sA[(mt * ks_n + ks) * 32 + lane];
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_s8(acc[mt][t], a, b[t][0], b[t][1]);
    }
  }
}

// The output bytes of one chunk, by lane: store(row, c, word) with c the
// column of the word's first byte from the chunk's start. Byte 0 of every
// sum is 0x00 or 0x80 (its parity in bit 7), so gather0 and a shift put a
// bit in place with no mask.
template <int MT, class Store>
__device__ __forceinline__ void pack(const int (&acc)[MT][4][4], int lane,
                                     Store store) {
  const int g = lane >> 2, tig = lane & 3;
  if constexpr (MT == 2) {
    // A row g + 8h of m-tile mt is bit 4(g >> 2) + 2mt + h of output g & 3:
    // lanes g and g ^ 4 hold the two nibbles of one output at columns
    // 8tig .. 8tig + 7 (4e + t for sum register 2h + e of n-tile t). Each
    // keeps the columns of its nibble (e = g >> 2) and trades the others.
    const int nib = g >> 2;
    uint32_t half[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t v = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mt = q >> 1, r = 2 * (q & 1) + e;
        v |= gather0(acc[mt][0][r], acc[mt][1][r], acc[mt][2][r],
                     acc[mt][3][r]) >> (7 - q);
      }
      half[e] = v;
    }
    const uint32_t keep = (nib ? half[1] : half[0]) << (4 * nib);
    const uint32_t send = (nib ? half[0] : half[1]) << (4 * nib);
    store(g & 3, 8 * tig + 4 * nib,
          keep | __shfl_xor_sync(kFull, send, 16));
  } else {
    // A row g + 8h of m-tile mt is bit q & 7 of output g + 8(q >> 3), q =
    // 2mt + h: a lane holds whole bytes, columns 8tig + 4e + t.
#pragma unroll
    for (int u = 0; u < MT / 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int mt = 4 * u + (b >> 1), r = 2 * (b & 1) + e;
          v |= gather0(acc[mt][0][r], acc[mt][1][r], acc[mt][2][r],
                       acc[mt][3][r]) >> (7 - b);
        }
        store(g + 8 * u, 8 * tig + 4 * e, v);
      }
    }
  }
}

// Chunks a span and blocks of kThreads an SM the registers must leave room
// for, by instantiation (MT m-tiles, KSM K slices unrolled). Timed on an
// H100 where the repository's shapes launch (MT = 2; PERF.md section 6):
// k <= 16 runs fastest with spans of 4 chunks in the 80 registers ptxas
// chooses itself (3 blocks an SM; held to 3 blocks, the same 80 ran 3-5 %
// slower), k <= 32 with one chunk held to 4 blocks (more chunks ahead cost
// it the fourth block). The others take one chunk and the blocks their
// sums leave room for. 0: not held.
__host__ __device__ constexpr int span_chunks(int mt, int ksm) {
  return mt == 2 && ksm == 4 ? 4 : 1;
}
__host__ __device__ constexpr int min_blocks(int mt, int ksm) {
  return mt == 2 ? (ksm == 4 ? 0 : ksm == 8 ? 4 : 2) : mt == 4 ? 2 : 1;
}

// span_chunks chunks of 32 columns make a span. A warp takes whole spans
// (every column inside n, rows 4-byte aligned) with straight-line u32 loads
// and stores, the loads of its next span in flight while it works on this
// one; then the rest, one chunk at a time, through the masked byte path.
// KSM K slices are unrolled, ks_n <= KSM of them run.
template <int MT, int KSM>
__device__ __forceinline__ void bitplane(const uint8_t* __restrict__ in,
                                         uint8_t* __restrict__ out,
                                         const uint4* __restrict__ frags,
                                         int o, int k, int ks_n,
                                         long long nchunks, const Layout& L) {
  extern __shared__ uint4 sA[];  // [MT][ks_n][32 lanes]
  for (int i = threadIdx.x; i < MT * ks_n * 32; i += kThreads) {
    sA[i] = __ldg(frags + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint8_t* src = in + blockIdx.y * L.in_bs;
  uint8_t* dst = out + blockIdx.y * L.out_bs;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  // the lane's input row in K slice ks is 4ks + tig, its columns 4g .. +3
  const uint8_t* lane_src = src + tig * L.in_rs + 4 * g;
  const long long slice_rs = 4 * L.in_rs;
  constexpr int S = span_chunks(MT, KSM);
  constexpr long long kSpan = static_cast<long long>(S) * kChunk;
  const long long whole = L.in_vec && L.out_vec ? L.n / kSpan : 0;

  uint32_t w[S][KSM];
  long long span = warp;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      w[s][ks] = 0u;
      if (span < whole && ks < ks_n && 4 * ks + tig < k) {
        w[s][ks] = __ldg(reinterpret_cast<const uint32_t*>(
            lane_src + ks * slice_rs + span * kSpan + s * kChunk));
      }
    }
  }
  for (; span < whole; span += warps) {
    const long long next = span + warps;
    const bool more = next < whole;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long col0 = span * kSpan + s * kChunk;
      int acc[MT][4][4];
      product<MT, KSM>(
          acc, w[s], ks_n, sA, lane, [&](int ks, uint32_t& slot) {
            if (more && 4 * ks + tig < k) {
              slot = __ldg(reinterpret_cast<const uint32_t*>(
                  lane_src + ks * slice_rs + next * kSpan + s * kChunk));
            }
          });
      pack<MT>(acc, lane, [&](int row, int c, uint32_t word) {
        if (row < o) {
          *reinterpret_cast<uint32_t*>(dst + row * L.out_rs + col0 + c) =
              word;
        }
      });
    }
  }
  for (long long chunk = whole * S + warp; chunk < nchunks; chunk += warps) {
    const long long col0 = chunk * kChunk;
    const long long col = col0 + 4 * g;
    uint32_t x[KSM];
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      x[ks] = ks < ks_n && 4 * ks + tig < k && col < L.n
          ? load4(lane_src + ks * slice_rs + col0, L.n - col, L.in_vec)
          : 0u;
    }
    int acc[MT][4][4];
    product<MT, KSM>(acc, x, ks_n, sA, lane, [](int, uint32_t&) {});
    pack<MT>(acc, lane, [&](int row, int c, uint32_t word) {
      const long long cc = col0 + c;
      if (row < o && cc < L.n) {
        store4(dst + row * L.out_rs + cc, word, L.n - cc, L.out_vec);
      }
    });
  }
}

// The two entry points differ only in their launch bounds (min_blocks).
template <int MT, int KSM>
__global__ void __launch_bounds__(kThreads)
    gf_bitplane_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out,
                       const uint4* __restrict__ frags, int o, int k, int ks_n,
                       long long nchunks, const Layout L) {
  bitplane<MT, KSM>(in, out, frags, o, k, ks_n, nchunks, L);
}

template <int MT, int KSM>
__global__ void __launch_bounds__(kThreads, min_blocks(MT, KSM))
    gf_bitplane_kernel_held(const uint8_t* __restrict__ in,
                            uint8_t* __restrict__ out,
                            const uint4* __restrict__ frags, int o, int k,
                            int ks_n, long long nchunks, const Layout L) {
  bitplane<MT, KSM>(in, out, frags, o, k, ks_n, nchunks, L);
}

template <int MT, int KSM>
int launch(const void* in, void* out, const void* frags, int o, int k,
           long long n, int batch, const Layout& L, int device,
           cudaStream_t stream) {
  auto* kernel = [] {
    if constexpr (min_blocks(MT, KSM) > 0) {
      return &gf_bitplane_kernel_held<MT, KSM>;
    } else {
      return &gf_bitplane_kernel<MT, KSM>;
    }
  }();
  const int ks_n = (k + 3) / 4;
  const size_t smem = static_cast<size_t>(MT) * ks_n * 32 * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nchunks = (n + kChunk - 1) / kChunk;
  constexpr int S = span_chunks(MT, KSM);
  const long long spans = (nchunks + S - 1) / S;
  const long long need = (spans + kWarps - 1) / kWarps;
  // one wave: the batch shares the blocks that fit on the card at once
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = blocks >= batch ? blocks / batch : 1;
  const dim3 grid(static_cast<unsigned>(need < blocks ? need : blocks),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint4*>(frags), o, k, ks_n, nchunks, L);
  return static_cast<int>(cudaGetLastError());
}

// K slices unrolled: 4 (k <= 16, every RS(k<=16) shape), 8 or 16
template <int MT>
int launch_ks(const void* in, void* out, const void* frags, int o, int k,
              long long n, int batch, const Layout& L, int device,
              cudaStream_t s) {
  const int ks_n = (k + 3) / 4;
  if (ks_n <= 4) {
    return launch<MT, 4>(in, out, frags, o, k, n, batch, L, device, s);
  }
  if (ks_n <= 8) {
    return launch<MT, 8>(in, out, frags, o, k, n, batch, L, device, s);
  }
  return launch<MT, 16>(in, out, frags, o, k, n, batch, L, device, s);
}

}  // namespace

extern "C" {

const char* gf_bitplane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] (byte strides in_bs, in_rs); out: device
// u8 [batch, o, >= n] (out_bs, out_rs); frags: device [MT][ceil(k/4)][32]
// [16] int8 A fragments (MT = 2 for o <= 4, 4 for o <= 8, else 8), 16-byte
// aligned.
int gf_bitplane_launch(const void* in, void* out, const void* frags, int o,
                       int k, long long n, int batch, long long in_bs,
                       long long in_rs, long long out_bs, long long out_rs,
                       int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n < 0 || batch < 1 ||
      batch > 65535 || (reinterpret_cast<uintptr_t>(frags) & 15u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t ip = reinterpret_cast<uintptr_t>(in);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const Layout L{n, in_bs, in_rs, out_bs, out_rs,
                 ((ip | static_cast<uintptr_t>(in_bs) |
                   static_cast<uintptr_t>(in_rs)) & 3u) == 0,
                 ((op | static_cast<uintptr_t>(out_bs) |
                   static_cast<uintptr_t>(out_rs)) & 3u) == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o <= 4) {
    return launch_ks<2>(in, out, frags, o, k, n, batch, L, device, s);
  }
  if (o <= 8) {
    return launch_ks<4>(in, out, frags, o, k, n, batch, L, device, s);
  }
  return launch_ks<8>(in, out, frags, o, k, n, batch, L, device, s);
}

}  // extern "C"
