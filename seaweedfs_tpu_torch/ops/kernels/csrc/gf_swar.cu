// GF(2^8)/0x11d matrix product on packed bytes, for Hopper (sm_90a).
//
//   out[b, i, :] = XOR_d  C[i, d] ∘GF in[b, d, :]      i < O, d < k
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py:_swar_kernel
// (with _xtime_swar), which carries every byte of Reed-Solomon encode and
// rebuild. Same algebra: four shard bytes sit in each u32, and multiplying
// them by 2 in the field is the byte-parallel xtime
//   ((x & 0x7f7f7f7f) << 1) ^ (((x >> 7) & 0x01010101) * 0x1d).
// For each input row the kernel doubles the word once per coefficient bit
// and XORs it into every output accumulator whose coefficient has that bit.
//
// What bounds it on an H100 SXM: per u32 of an RS(10,4) parity product it
// does 60 doublings and 156 XORs against 56 bytes of traffic. As built, a
// doubling is 3 instructions on the integer ALU pipe (SHF, two LOP3) and 2
// on the FMA pipe (IMAD.SHL, IMAD), and an XOR is one LOP3: 336 ALU-pipe
// operations, 6 a byte, above the card's balance of 5 (the ALU pipe's
// 16.7 T op/s over HBM3 at 3.35 TB/s). So it is bound by integer
// operations, not bytes. The design follows: keep every accumulator in
// registers (a template over O), load 16 bytes a thread with neighbouring
// threads on neighbouring words so the loads are few and coalesced, and
// pay little for run-time coefficients. The coefficients arrive in a
// kernel-argument struct (reconstruction matrices change with the loss
// pattern, 1,470 of them for 1-4 losses of RS(10,4), so they cannot be
// compile-time); the branch on each coefficient bit reads constant-bank
// parameters that are the same for the whole warp, so it never diverges.
// The compiler turns that branch into predicated XORs, which issue whether
// or not the bit is set: O per input row and bit where the work needs one
// per set bit (280 against 156 per word for the RS(10,4) parity).
//
// Layout: in is [batch, k, n16] and out [batch, O, n16] uint4 words, rows
// contiguous and 16-byte aligned. Limits: O <= 16, k <= 64, batch <= 65535.
// The launcher allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOut = 16;
constexpr int kMaxIn = 64;
constexpr int kThreads = 256;

// The kernel-argument form of a coefficient matrix C[O, k]:
// mask[d][b] has bit i set when bit b of C[i][d] is set; top[d] is the
// number of bits input row d needs (0: the row feeds no output).
struct SwarCoeff {
  uint16_t mask[kMaxIn][8];
  uint8_t top[kMaxIn];
};
static_assert(sizeof(SwarCoeff) == kMaxIn * 8 * 2 + kMaxIn,
              "SwarCoeff must match the packing of gf_swar.py");

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1du);
}

__device__ __forceinline__ uint4 xtime4(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_swar_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int k, long long n16, const SwarCoeff coeff) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= n16) return;
  const uint4* src = in + static_cast<long long>(blockIdx.y) * k * n16 + col;
  uint4* dst = out + static_cast<long long>(blockIdx.y) * O * n16 + col;

  uint4 acc[O];
#pragma unroll
  for (int i = 0; i < O; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int d = 0; d < k; ++d) {
    const int top = coeff.top[d];
    if (top == 0) continue;
    uint4 x = __ldg(src + d * n16);
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
  for (int i = 0; i < O; ++i) dst[i * n16] = acc[i];
}

template <int O>
void launch(const void* in, void* out, int k, long long n16, int batch,
            const SwarCoeff& coeff, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n16 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  gf_swar_kernel<O><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), k, n16,
      coeff);
}

}  // namespace

extern "C" {

int gf_swar_coeff_bytes() { return static_cast<int>(sizeof(SwarCoeff)); }

int gf_swar_max_out() { return kMaxOut; }

int gf_swar_max_in() { return kMaxIn; }

const char* gf_swar_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device [batch, k, n16] uint4; out: device [batch, o, n16] uint4;
// coeff: host pointer to gf_swar_coeff_bytes() bytes of SwarCoeff;
// stream: a cudaStream_t (0 for the legacy default stream).
int gf_swar_launch(const void* in, void* out, int o, int k, long long n16,
                   int batch, const void* coeff, int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n16 < 0 || batch < 1 ||
      batch > 65535 || n16 > 0x7fffffffLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
      15u) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n16 == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (o) {
    case 1: launch<1>(in, out, k, n16, batch, c, s); break;
    case 2: launch<2>(in, out, k, n16, batch, c, s); break;
    case 3: launch<3>(in, out, k, n16, batch, c, s); break;
    case 4: launch<4>(in, out, k, n16, batch, c, s); break;
    case 5: launch<5>(in, out, k, n16, batch, c, s); break;
    case 6: launch<6>(in, out, k, n16, batch, c, s); break;
    case 7: launch<7>(in, out, k, n16, batch, c, s); break;
    case 8: launch<8>(in, out, k, n16, batch, c, s); break;
    case 9: launch<9>(in, out, k, n16, batch, c, s); break;
    case 10: launch<10>(in, out, k, n16, batch, c, s); break;
    case 11: launch<11>(in, out, k, n16, batch, c, s); break;
    case 12: launch<12>(in, out, k, n16, batch, c, s); break;
    case 13: launch<13>(in, out, k, n16, batch, c, s); break;
    case 14: launch<14>(in, out, k, n16, batch, c, s); break;
    case 15: launch<15>(in, out, k, n16, batch, c, s); break;
    case 16: launch<16>(in, out, k, n16, batch, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
