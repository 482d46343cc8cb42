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
// The launchers allocate nothing, launch on the caller's stream and return
// cudaGetLastError().
//
// Two more launch forms of the same column work answer the questions
// tools/exp_batched.py asked of the TPU about a batch of volumes: the batch
// as the fastest block index (its swapped grid of _swar_kernel) and one
// thread walking all V volumes of its column word on a grid over columns
// only (its _swar_fusedv_kernel). Each thread of any form does the same
// work per column word and volume; only the order in which blocks reach
// the SMs and the number of threads differ.

#include <cstring>

#include "gf_common.cuh"

namespace {

// out[i] = XOR_d C[i, d] ∘GF in[d] for one uint4 column word; in and out
// point at row 0 of the column, rows n16 words apart.
template <int O>
__device__ __forceinline__ void swar_column(const uint4* __restrict__ src,
                                            uint4* __restrict__ dst, int k,
                                            long long n16,
                                            const SwarCoeff& coeff) {
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

// The batch on gridDim.y, columns on x.
template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_swar_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int k, long long n16,
                   const __grid_constant__ SwarCoeff coeff) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= n16) return;
  swar_column<O>(in + static_cast<long long>(blockIdx.y) * k * n16 + col,
                 out + static_cast<long long>(blockIdx.y) * O * n16 + col, k,
                 n16, coeff);
}

// The batch as the fastest block index: blocks b, b+1, ... of one column
// block are neighbours in launch order (tools/exp_batched.py's swapped
// grid, build_batched_swapped).
template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_swar_batch_fastest_kernel(const uint4* __restrict__ in,
                                 uint4* __restrict__ out, int k,
                                 long long n16, int batch,
                                 const __grid_constant__ SwarCoeff coeff) {
  const long long b = blockIdx.x % batch;
  const long long col =
      static_cast<long long>(blockIdx.x / batch) * kThreads + threadIdx.x;
  if (col >= n16) return;
  swar_column<O>(in + b * k * n16 + col, out + b * O * n16 + col, k, n16,
                 coeff);
}

// All volumes in one thread: a grid over columns only, each thread walking
// the V volumes of its column word (tools/exp_batched.py's
// _swar_fusedv_kernel, one program for all volumes).
template <int O>
__global__ void __launch_bounds__(kThreads)
    gf_swar_fusedv_kernel(const uint4* __restrict__ in,
                          uint4* __restrict__ out, int k, long long n16,
                          int volumes,
                          const __grid_constant__ SwarCoeff coeff) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= n16) return;
  for (int v = 0; v < volumes; ++v) {
    swar_column<O>(in + static_cast<long long>(v) * k * n16 + col,
                   out + static_cast<long long>(v) * O * n16 + col, k, n16,
                   coeff);
  }
}

// Argument checks shared by the launchers; 0 when the call may go ahead.
int check_args(const void* in, const void* out, int o, int k, long long n16,
               int device) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n16 < 0 ||
      n16 > 0x7fffffffLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
      15u) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaSetDevice(device));
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
  if (batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = check_args(in, out, o, k, n16, device);
  if (rc || n16 == 0) return rc;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>((n16 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_out(o, [&](auto oc) {
    gf_swar_kernel<decltype(oc)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), k, n16, c);
  });
  return static_cast<int>(cudaGetLastError());
}

// The same product with the batch as the fastest block index (one
// dimension of blocks(n16) x batch).
int gf_swar_batch_fastest_launch(const void* in, void* out, int o, int k,
                                 long long n16, int batch, const void* coeff,
                                 int device, void* stream) {
  const long long blocks = (n16 + kThreads - 1) / kThreads;
  if (batch < 1 || blocks * batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = check_args(in, out, o, k, n16, device);
  if (rc || n16 == 0) return rc;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>(blocks * batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_out(o, [&](auto oc) {
    gf_swar_batch_fastest_kernel<decltype(oc)::value>
        <<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(in),
                                   static_cast<uint4*>(out), k, n16, batch,
                                   c);
  });
  return static_cast<int>(cudaGetLastError());
}

// The same product over `volumes` volumes in one thread per column word.
int gf_swar_fusedv_launch(const void* in, void* out, int o, int k,
                          long long n16, int volumes, const void* coeff,
                          int device, void* stream) {
  if (volumes < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc = check_args(in, out, o, k, n16, device);
  if (rc || n16 == 0) return rc;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>((n16 + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_out(o, [&](auto oc) {
    gf_swar_fusedv_kernel<decltype(oc)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), k, n16,
        volumes, c);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
