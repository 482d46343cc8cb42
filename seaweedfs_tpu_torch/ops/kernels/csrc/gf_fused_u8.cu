// GF(2^8)/0x11d matrix product on u8 shard rows in one pass that repacks
// each tile into u32 words, runs the SWAR algebra on them and unpacks the
// result, for Hopper (sm_90a).
//
//   out[b, i, c] = XOR_d  C[i, d] ∘GF in[b, d, c]      i < O, d < k, c < n
//
// Replaces the TPU kernel tools/exp_dev8b.py fused_u8_kernel, the sweep's
// "fused block-repack swar" variant: per tile of T bytes it bitcasts the
// [k, T] block into [k, T/4] u32 words whose byte s is quarter s of the
// tile (the layout of gf_repack.cu, q = T/4:
//   word[t*q + j] = in[t*T + j] | in[t*T + q + j] << 8 | ... << 24),
// runs gf_swar.cu's doubling-and-XOR algebra on the words and bitcasts the
// [o, T/4] result back. The output is the plain GF product.
//
// On Hopper the repack is a 4x4 byte transpose (gf_common.cuh's
// transpose4, the one gf_repack.cu uses): a thread loads U bytes at offset
// j from each of the tile's four quarters of a row, turns them into U
// tile-local words with PRMTs, does the SWAR work on the words, and turns
// each output's U words back into four quarters before it stores them.
// Since the arithmetic is byte-wise, the product needs no transposes;
// gf_swar_u8.cu loads the bytes as they lie. With run-time coefficients
// this kernel is bound by integer ALU-pipe operations (6 a byte at
// RS(10,4) against the card's balance of 5); the transposes add 2 PRMTs a
// word each way, about 28 operations to some 490 a word. It ran ahead of
// gf_swar_u8's first design (one 16-byte word a thread, run-time
// coefficients only) by holding 64 bytes of each row a thread; gf_swar_u8
// now has gf_swar's compile-time RS(10,4) form and is the faster of the two
// on the parity (PERF.md), so this kernel stays the dev8b sweep's variant.
//
// U is 16 bytes a quarter for O <= 4 (64 bytes of a row a thread), 8 for
// O <= 8 and 4 above, so the accumulators stay at 64 registers; it needs
// q % U == 0 and moves whole words where the rows are aligned to U. A tile
// whose quarter is no multiple of U (T < 16 or odd quarters) goes through a
// scalar form, one word (a byte from each quarter) a thread. Bytes past the
// row's width n read as 0 and are not written, so a ragged width needs no
// padding copy; rows may be strided. Coefficients come at run time in
// gf_common.cuh's SwarCoeff struct. Limits: O <= 16, k <= 64,
// batch <= 65535. The launcher allocates nothing, launches on the caller's
// stream and returns cudaGetLastError().

#include <cstring>

#include "gf_common.cuh"

namespace {

// Bytes a thread takes from each quarter for O outputs.
__host__ __device__ constexpr int unit_bytes(int o) {
  return o <= 4 ? 16 : (o <= 8 ? 8 : 4);
}

// The SWAR product of W words a thread holds for each input row; `load(d,
// x)` fills input row d's words. Accumulates into acc[O][W].
template <int O, int W, typename Load>
__device__ __forceinline__ void swar_words(int k, const SwarCoeff& coeff,
                                           Load&& load,
                                           uint32_t (&acc)[O][W]) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = 0u;
  }
  for (int d = 0; d < k; ++d) {
    const int top = coeff.top[d];
    if (top == 0) continue;
    uint32_t x[W];
    load(d, x);
    for (int b = 0; b < top; ++b) {
      if (b) {
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = xtime(x[w]);
      }
      const unsigned m = coeff.mask[d][b];
#pragma unroll
      for (int i = 0; i < O; ++i) {
        if (m & (1u << i)) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[i][w] ^= x[w];
        }
      }
    }
  }
}

// One thread: U bytes of each quarter of one tile, U words.
template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_fused_u8_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int k, long long q,
                       const Layout L,
                       const __grid_constant__ SwarCoeff coeff) {
  constexpr int U = unit_bytes(O);
  const long long unit =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long per_tile = q / U;
  const long long t = unit / per_tile;
  const long long c0 = t * 4 * q + (unit - t * per_tile) * U;
  if (c0 >= L.n) return;  // quarter 0 holds the tile's lowest columns
  const uint8_t* src = in + blockIdx.y * L.in_bs + c0;
  uint8_t* dst = out + blockIdx.y * L.out_bs + c0;

  uint32_t acc[O][U];
  swar_words<O, U>(k, coeff, [&](int d, uint32_t (&x)[U]) {
    uint32_t a[4][U / 4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const long long c = c0 + s * q;
      if (c < L.n) {
        load_bytes<U>(src + d * L.in_rs + s * q, L.n - c, L.in_vec,
                      a[s]);
      } else {
#pragma unroll
        for (int g = 0; g < U / 4; ++g) a[s][g] = 0u;
      }
    }
#pragma unroll
    for (int g = 0; g < U / 4; ++g) {
      transpose4(a[0][g], a[1][g], a[2][g], a[3][g], x[4 * g], x[4 * g + 1],
                 x[4 * g + 2], x[4 * g + 3]);
    }
  }, acc);

#pragma unroll
  for (int i = 0; i < O; ++i) {
    uint32_t a[4][U / 4];
#pragma unroll
    for (int g = 0; g < U / 4; ++g) {
      transpose4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                 acc[i][4 * g + 3], a[0][g], a[1][g], a[2][g], a[3][g]);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const long long c = c0 + s * q;
      if (c < L.n) {
        store_bytes<U>(dst + i * L.out_rs + s * q, a[s], L.n - c,
                       L.out_vec);
      }
    }
  }
}

// One thread: one word, byte s from quarter s of one tile.
template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_fused_u8_scalar(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int k, long long q,
                       const Layout L,
                       const __grid_constant__ SwarCoeff coeff) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long c0 = (w / q) * 4 * q + w % q;
  if (c0 >= L.n) return;
  const uint8_t* src = in + blockIdx.y * L.in_bs + c0;
  uint8_t* dst = out + blockIdx.y * L.out_bs + c0;

  uint32_t acc[O][1];
  swar_words<O, 1>(k, coeff, [&](int d, uint32_t (&x)[1]) {
    uint32_t v = 0u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (c0 + s * q < L.n) {
        v |= static_cast<uint32_t>(__ldg(src + d * L.in_rs + s * q))
             << (8 * s);
      }
    }
    x[0] = v;
  }, acc);

#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (c0 + s * q < L.n) {
        dst[i * L.out_rs + s * q] =
            static_cast<uint8_t>(acc[i][0] >> (8 * s));
      }
    }
  }
}

}  // namespace

extern "C" {

int gf_fused_u8_coeff_bytes() { return static_cast<int>(sizeof(SwarCoeff)); }

const char* gf_fused_u8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] with byte strides (in_bs, in_rs);
// out: device u8 [batch, o, >= n] with byte strides (out_bs, out_rs);
// tile: bytes, a positive multiple of 4; coeff: host pointer to
// gf_fused_u8_coeff_bytes() bytes of SwarCoeff.
int gf_fused_u8_launch(const void* in, void* out, int o, int k, long long n,
                       long long tile, int batch, long long in_bs,
                       long long in_rs, long long out_bs, long long out_rs,
                       const void* coeff, int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n < 0 || batch < 1 ||
      batch > 65535 || tile < 4 || tile % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long q = tile / 4;
  const long long words = (n + tile - 1) / tile * q;  // per row
  const int u = unit_bytes(o);
  const bool scalar = q % u != 0;
  const long long threads = scalar ? words : words / u;
  if ((threads + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L{n, in_bs, in_rs, out_bs, out_rs,
                 aligned(in, in_bs, in_rs, u),
                 aligned(out, out_bs, out_rs, u)};
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  const bool known = dispatch_out(o, [&](auto oc) {
    constexpr int O = decltype(oc)::value;
    if (scalar) {
      gf_fused_u8_scalar<O><<<grid, kThreads, 0, s>>>(src, dst, k, q, L, c);
    } else {
      gf_fused_u8_kernel<O><<<grid, kThreads, 0, s>>>(src, dst, k, q, L, c);
    }
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
