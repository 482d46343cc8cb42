// GF(2^8)/0x11d matrix product straight from u8 shard rows in device
// memory, of any width and any row stride, for Hopper (sm_90a).
//
//   out[b, i, c] = XOR_d  C[i, d] ∘GF in[b, d, c]      i < O, d < k, c < n
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py
// _swar_u8_kernel, reached through _gf_matmul_swar_u8_device (method
// "swar" on a device-u8 slab). The algebra is gf_swar.cu's: four bytes to
// a u32 and the byte-parallel doubling
//   ((x & 0x7f7f7f7f) << 1) ^ (((x >> 7) & 0x01010101) * 0x1d),
// one doubling per coefficient bit, XOR into every output whose
// coefficient has that bit. The TPU kernel regroups each row's bytes into
// u32 lanes with an in-VMEM bitcast; here a thread groups 16 consecutive
// bytes into four u32 in registers (any grouping gives the same bytes,
// since the arithmetic is byte-wise).
//
// What makes it a route of its own: it takes the rows as they lie. A
// ragged tail is read and written byte by byte with a mask, and rows may
// be a strided view (the first 10 rows of a [14, N] shard tensor), so the
// route makes no padding copy; the reference pads with jnp.pad
// (_pad_and_run) and gf_swar.py pads to 16 bytes with F.pad. Where rows
// and pointers are 16-byte aligned, whole 16-byte words move in one load
// or store; elsewhere bytes do. Like gf_swar.cu it is bound by integer
// ALU-pipe operations at RS(10,4) (6 a byte against the card's balance of
// 5), not bytes.
//
// Coefficients come at run time in the SwarCoeff struct of gf_common.cuh
// (packed by gf_swar.coeff_from_reference). Limits: O <= 16, k <= 64,
// batch <= 65535. The launcher allocates nothing, launches on the caller's
// stream and returns cudaGetLastError().

#include <cstring>

#include "gf_common.cuh"

namespace {

template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_swar_u8_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int k, const Layout L,
                      const __grid_constant__ SwarCoeff coeff) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 16;
  if (col >= L.n) return;
  const long long avail = L.n - col;
  const uint8_t* src = in + blockIdx.y * L.in_bs + col;
  uint8_t* dst = out + blockIdx.y * L.out_bs + col;

  uint4 acc[O];
#pragma unroll
  for (int i = 0; i < O; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int d = 0; d < k; ++d) {
    const int top = coeff.top[d];
    if (top == 0) continue;
    uint32_t w[4];
    load_bytes<16>(src + d * L.in_rs, avail, L.in_vec, w);
    uint4 x = make_uint4(w[0], w[1], w[2], w[3]);
    for (int b = 0; b < top; ++b) {
      if (b) x = xtime4(x);
      const unsigned m = coeff.mask[d][b];
#pragma unroll
      for (int i = 0; i < O; ++i) {
        if (m & (1u << i)) xor_into(acc[i], x);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < O; ++i) {
    const uint32_t w[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
    store_bytes<16>(dst + i * L.out_rs, w, avail, L.out_vec);
  }
}

template <int O>
void launch(const void* in, void* out, int k, int batch, const Layout& L,
            const SwarCoeff& coeff, cudaStream_t stream) {
  const long long n16 = (L.n + 15) / 16;
  const dim3 grid(static_cast<unsigned>((n16 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  gf_swar_u8_kernel<O><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), k, L,
      coeff);
}

}  // namespace

extern "C" {

int gf_swar_u8_coeff_bytes() { return static_cast<int>(sizeof(SwarCoeff)); }

const char* gf_swar_u8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] with byte strides (in_bs, in_rs);
// out: device u8 [batch, o, >= n] with byte strides (out_bs, out_rs);
// coeff: host pointer to gf_swar_u8_coeff_bytes() bytes of SwarCoeff.
int gf_swar_u8_launch(const void* in, void* out, int o, int k, long long n,
                      int batch, long long in_bs, long long in_rs,
                      long long out_bs, long long out_rs, const void* coeff,
                      int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n < 0 || batch < 1 ||
      batch > 65535 || (n + 15) / 16 > 0x7fffffffLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L{n, in_bs, in_rs, out_bs, out_rs,
                 aligned(in, in_bs, in_rs, 16),
                 aligned(out, out_bs, out_rs, 16)};
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dispatch_out(o, [&](auto oc) {
        launch<decltype(oc)::value>(in, out, k, batch, L, c, s);
      })) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
