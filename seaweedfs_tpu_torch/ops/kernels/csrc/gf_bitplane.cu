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
// cores with int32 sums (mma.sync m16n8k32 .s8.s8.s32). Every sum is at most
// k*8 <= 512, exact in int32 for every k taken.
//
// Each warp works alone on chunks of 32 columns, with no block barrier in
// its loop, and the bits never touch memory:
//   1. unpack into registers: the B operand of m16n8k32 wants, for mma
//      column n, 4 consecutive K rows in one register. K row d*8+j is bit j
//      of input row d, so a lane loads one u32 of 4 consecutive columns of
//      each input row it needs and spreads a nibble of each byte into 4
//      bytes of 0/1 ((x & 0xf) * 0x204081 & 0x01010101). Column n of
//      n-tile t stands for data column 4n + t, so the 4 columns of the
//      lane's u32 are its own in the chunk's 4 n-tiles;
//   2. product: A, the padded B[o8, k8] already cut by the wrapper into
//      each lane's fragment registers, comes from shared memory (one
//      16-byte load a fragment; loaded once per block);
//   3. pack in registers: bit 0 of the int32 sums is gathered across the
//      warp with __ballot_sync; a lane then owns 4 output bytes of one
//      output row (one mma column in the 4 n-tiles), gathers every fourth
//      ballot bit into each byte, and stores them as one u32.
//
// What bounds it: at RS(10,4) the tensor-core work (2 * 32 * 80 operations
// a column) is small beside the unpack and pack, which are integer work on
// the ALU and FMA pipes (chip_smoke.py counts them). The bytes are read
// once and written once. Columns past n read as 0 and are not written, and
// rows may be strided, so the caller makes no padding copy.
//
// Layout: in [batch, k, >= n] and out [batch, o, >= n] u8 with byte strides;
// frags is B padded to [16*MT, 32*KS] and cut into mma A fragments,
// [MT][KS][32 lanes][4 u32]. Limits: o <= 16, k <= 64, batch <= 65535. The
// launcher allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOut = 16;
constexpr int kMaxIn = 64;
constexpr int kMaxKS = kMaxIn / 4;  // K slices of 32 bit rows = 4 inputs
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;          // columns a warp takes at a time
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

// bits 0..3 of x, one to a byte: byte i = bit i.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xfu) * 0x204081u) & 0x01010101u;
}

// bits 0, 4, 8, ..., 28 of x, packed into bits 0..7.
__device__ __forceinline__ uint32_t gather8(uint32_t x) {
  x &= 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000f000fu;
  return (x | (x >> 12)) & 0xffu;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    gf_bitplane_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out,
                       const uint4* __restrict__ frags, int o, int k, int ks_n,
                       long long nchunks, const Layout L) {
  extern __shared__ uint4 sA[];  // [MT][ks_n][32 lanes]
  for (int i = threadIdx.x; i < MT * ks_n * 32; i += kThreads) {
    sA[i] = __ldg(frags + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint8_t* src = in + blockIdx.y * L.in_bs;
  uint8_t* dst = out + blockIdx.y * L.out_bs;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long chunk =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       chunk < nchunks; chunk += warps) {
    const long long col0 = chunk * kChunk;
    const long long col = col0 + 4 * g;  // this lane's 4 columns
    const int sh = 4 * (tig & 1);

    int acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][t][r] = 0;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kMaxKS; ++ks) {
      if (ks >= ks_n) break;
      // this lane's input rows in K slice ks: 4ks + tig/2 (b0) and
      // 4ks + 2 + tig/2 (b1), bits 4*(tig&1) .. +3 of each byte
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 4 * ks + 2 * h + (tig >> 1);
        w[h] = d < k && col < L.n
            ? load4(src + d * L.in_rs + col, L.n - col, L.in_vec) : 0u;
      }
      uint32_t b[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {  // n-tile t: byte t of each word
        b[t][0] = spread4(w[0] >> (8 * t + sh));
        b[t][1] = spread4(w[1] >> (8 * t + sh));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = sA[(mt * ks_n + ks) * 32 + lane];
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8(acc[mt][t], a, b[t][0], b[t][1]);
      }
    }

    // pack: lanes 0-15 take m-tile 2p, lanes 16-31 m-tile 2p+1. Lane
    // (r, q) = ((lane & 15) >> 2, lane & 3) owns sum register r of mma
    // column 2q + (r & 1) in the 4 n-tiles: output row 2*mt + (r >> 1),
    // data columns 4n .. 4n+3 with n = 2q + (r & 1).
    const int half = lane >> 4, r = (lane & 15) >> 2, q = lane & 3;
#pragma unroll
    for (int p = 0; p < (MT + 1) / 2; ++p) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t mine = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * p + h >= MT) break;
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const uint32_t vote =
                __ballot_sync(kFull, acc[2 * p + h][t][rr] & 1);
            if (h == half && rr == r) mine = vote;
          }
        }
        word |= gather8(mine >> q) << (8 * t);
      }
      const int mt = 2 * p + half;
      const int row = 2 * mt + (r >> 1);
      const long long c = col0 + 4 * (2 * q + (r & 1));
      if (mt < MT && row < o && c < L.n) {
        store4(dst + row * L.out_rs + c, word, L.n - c, L.out_vec);
      }
    }
  }
}

template <int MT>
int launch(const void* in, void* out, const void* frags, int o, int k,
           long long n, int batch, const Layout& L, int device,
           cudaStream_t stream) {
  const int ks_n = (k + 3) / 4;
  const size_t smem = static_cast<size_t>(MT) * ks_n * 32 * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      gf_bitplane_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gf_bitplane_kernel<MT>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long need = (nchunks + kWarps - 1) / kWarps;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = (blocks + batch - 1) / batch;  // fill the card across the batch
  const dim3 grid(static_cast<unsigned>(need < blocks ? need : blocks),
                  static_cast<unsigned>(batch));
  gf_bitplane_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint4*>(frags), o, k, ks_n, nchunks, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gf_bitplane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] (byte strides in_bs, in_rs); out: device
// u8 [batch, o, >= n] (out_bs, out_rs); frags: device
// [ceil(o/2)][ceil(k/4)][32][16] int8 A fragments, 16-byte aligned.
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
  switch ((o + 1) / 2) {  // m-tiles of 16 bit rows = 2 outputs
    case 1: return launch<1>(in, out, frags, o, k, n, batch, L, device, s);
    case 2: return launch<2>(in, out, frags, o, k, n, batch, L, device, s);
    case 3: return launch<3>(in, out, frags, o, k, n, batch, L, device, s);
    case 4: return launch<4>(in, out, frags, o, k, n, batch, L, device, s);
    case 5: return launch<5>(in, out, frags, o, k, n, batch, L, device, s);
    case 6: return launch<6>(in, out, frags, o, k, n, batch, L, device, s);
    case 7: return launch<7>(in, out, frags, o, k, n, batch, L, device, s);
    case 8: return launch<8>(in, out, frags, o, k, n, batch, L, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
