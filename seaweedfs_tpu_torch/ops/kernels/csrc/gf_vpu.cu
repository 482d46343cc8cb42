// GF(2^8)/0x11d matrix product with one shard byte per 32-bit register lane,
// for Hopper (sm_90a).
//
//   out[b, i, c] = XOR_d  C[i, d] ∘GF in[b, d, c]      i < O, d < k, c < n
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py _vpu_kernel
// (with _xtime), built by _build_call for method "vpu". Same arithmetic:
// each byte sits alone in an int32 lane, doubling in the field is
//   ((x << 1) & 0xff) ^ (x & 0x80 ? 0x1d : 0),
// each input row is doubled through its highest coefficient bit, and every
// set coefficient bit costs one XOR into its output. The reference keeps the
// route "for comparison": the SWAR kernels (gf_swar.cu, gf_swar_u8.cu) do
// the same operations on four bytes at once.
//
// What bounds it on an H100 SXM: per column of an RS(10,4) parity product
// (14 bytes of traffic) it does 60 doublings, each 2 ALU-pipe and 2
// FMA-pipe instructions, and 156 XORs: 276 ALU-pipe operations, some 20 a
// byte where the card's balance is 5. So it is bound by integer
// operations, about 3.3 times as many as the SWAR kernels do for the same
// bytes (336 for four columns). The design follows the reference's
// streaming order rather than its planes: a thread loads B bytes of one
// column block from each input row in turn (one 16-, 8- or 4-byte load),
// widens them to one byte per register with PRMT, doubles the row through
// its highest coefficient bit and XORs each doubling into the O output
// accumulators, so the registers hold O x B accumulators and one row's
// planes, never all k x 8 of them. B shrinks as O grows (16 bytes for
// O <= 4, 8 for O <= 8, 4 above) to keep the accumulators at 64 registers.
//
// Rows are taken as they lie, as gf_swar_u8.cu takes them: any width (the
// ragged tail is read and written byte by byte with a mask) and any row
// and batch stride, so the route makes no padding copy and a batch stays a
// grid axis (the reference moves it into the byte axis with a moveaxis
// copy). Coefficients come at run time in gf_common.cuh's SwarCoeff struct
// (packed by gf_swar.coeff_from_reference): reconstruction matrices vary
// with the loss pattern. Limits: O <= 16, k <= 64, batch <= 65535.
// The launcher allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstring>

#include "gf_common.cuh"

namespace {

// Bytes a thread takes from each row for O outputs.
__host__ __device__ constexpr int block_bytes(int o) {
  return o <= 4 ? 16 : (o <= 8 ? 8 : 4);
}

// One doubling of a byte held alone in a 32-bit lane.
__device__ __forceinline__ uint32_t xtime8(uint32_t x) {
  return ((x << 1) & 0xfeu) ^ ((x >> 7) * 0x1du);
}

template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_vpu_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int k, const Layout L,
                  const __grid_constant__ SwarCoeff coeff) {
  constexpr int B = block_bytes(O);
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * B;
  if (col >= L.n) return;
  const long long avail = L.n - col;
  const uint8_t* src = in + blockIdx.y * L.in_bs + col;
  uint8_t* dst = out + blockIdx.y * L.out_bs + col;

  uint32_t acc[O][B];
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < B; ++j) acc[i][j] = 0u;
  }

  for (int d = 0; d < k; ++d) {
    const int top = coeff.top[d];
    if (top == 0) continue;
    uint32_t w[B / 4];
    load_bytes<B>(src + d * L.in_rs, avail, L.in_vec, w);
    uint32_t x[B];  // byte j of the block alone in lane j
#pragma unroll
    for (int j = 0; j < B; ++j) {
      x[j] = __byte_perm(w[j >> 2], 0u, 0x4440u | (j & 3));
    }
    for (int b = 0; b < top; ++b) {
      if (b) {
#pragma unroll
        for (int j = 0; j < B; ++j) x[j] = xtime8(x[j]);
      }
      const unsigned m = coeff.mask[d][b];
#pragma unroll
      for (int i = 0; i < O; ++i) {
        if (m & (1u << i)) {
#pragma unroll
          for (int j = 0; j < B; ++j) acc[i][j] ^= x[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < O; ++i) {
    uint32_t w[B / 4];
#pragma unroll
    for (int q = 0; q < B / 4; ++q) {
      w[q] = acc[i][4 * q] | (acc[i][4 * q + 1] << 8) |
             (acc[i][4 * q + 2] << 16) | (acc[i][4 * q + 3] << 24);
    }
    store_bytes<B>(dst + i * L.out_rs, w, avail, L.out_vec);
  }
}

template <int O>
void launch(const void* in, void* out, int k, int batch, const Layout& L,
            const SwarCoeff& coeff, cudaStream_t stream) {
  constexpr int B = block_bytes(O);
  const long long units = (L.n + B - 1) / B;
  const dim3 grid(static_cast<unsigned>((units + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  gf_vpu_kernel<O><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), k, L,
      coeff);
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
      batch > 65535 || (n + 3) / 4 > 0x7fffffffLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b = block_bytes(o);
  const Layout L{n, in_bs, in_rs, out_bs, out_rs,
                 aligned(in, in_bs, in_rs, b),
                 aligned(out, out_bs, out_rs, b)};
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch_out(o, [&](auto oc) {
    launch<decltype(oc)::value>(in, out, k, batch, L, c, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
