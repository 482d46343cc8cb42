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
// The column algebra is gf_swar_column.cuh's, shared with gf_swar_u8.cu;
// this file gives it whole uint4 words of packed rows.
//
// What bounds it on an H100 SXM. Per u32 of an RS(10,4) parity product it
// does 60 doublings and 156 XORs against 56 bytes of traffic. A doubling
// is 3 instructions on the integer ALU pipe (SHF, two LOP3) and 2 on the
// FMA pipe (IMAD.SHL, IMAD); an XOR is at most one LOP3. With run-time
// coefficients the per-bit branch reads the kernel-argument struct, the
// same for the whole warp, so it never diverges, but it compiles to
// predicated XORs that issue whether or not the bit is set: O per input
// row and bit, 280 a word for the parity against the 156 it needs, about
// 460 ALU-pipe instructions a word in all. That issue rate bounds it, on
// large launches and on the encode's [10, 1 MiB] alike, where 65,536
// column words give each SM two blocks and nothing to overlap them with.
// HBM3 (3.35 TB/s) would allow the 56 bytes a word in less time. The
// design:
//
// - A compile-time form of the one matrix every ec.encode launch uses,
//    the RS(10,4) parity (rs10x4_coef). Each row, bit and output is a
//    template argument, so the kernel holds an XOR only for a set bit, as
//    the TPU kernel's trace-time constants do (_build_swar_call), and
//    ptxas folds two XORs into one three-input LOP3: 75 a word in the
//    built SASS where the run-time form issues 280, which leaves the
//    product nearer its byte bound than its operation bound. Every other matrix (the
//    1,470 reconstruction matrices of 1-4 losses, the other RS shapes,
//    the sweeps') takes the run-time form.
// - W column words a thread (a template parameter), chosen per launch by
//    the wrapper (gf_swar.py: choose_width). In the run-time form W = 2
//    shares each per-bit test among twice the words, where the launch
//    still gives every SM enough threads and the O x 2 accumulators fit
//    in registers (O <= 4); W = 4 measured slower than 2. The
//    compile-time form has no tests to share and stays at W = 1 (W = 2
//    measured slower, PERF.md). Word j of a thread is column
//    block * kThreads * W + j * kThreads + thread, so each load and store
//    instruction of a warp stays coalesced; words past n16 are masked.
// - One row loaded at a time: issuing the loads of several rows ahead
//    of their algebra measured no faster in either form (PERF.md), since
//    the small launch waits on ALU issue, not on load round trips.
//
// Layout: in is [batch, k, n16] and out [batch, O, n16] uint4 words, rows
// contiguous and 16-byte aligned. Limits: O <= 16, k <= 64, batch <= 65535.
// The launchers allocate nothing, launch on the caller's stream and return
// cudaGetLastError().
//
// Two more launch forms of the same column work answer the questions
// tools/exp_batched.py asked of the TPU about a batch of volumes: the batch
// as the fastest block index (its swapped grid of _swar_kernel) and one
// thread walking all V volumes of its column words on a grid over columns
// only (its _swar_fusedv_kernel). Each thread of any form does the same
// work per column word and volume; only the order in which blocks reach
// the SMs and the number of threads differ.

#include <cstring>

#include "gf_swar_column.cuh"

namespace {

// Row d's W words of packed rows n16 words apart: x[j] = row[word j], or 0
// for a word past n16.
struct WordRows {
  const uint4* src;  // row 0
  long long col, n16;

  template <int W>
  __device__ __forceinline__ void operator()(int d, uint4 (&x)[W]) const {
    const uint4* __restrict__ row = src + d * n16;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long c = word_col(col, j);
      x[j] = c < n16 ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// out[i] = XOR_d C[i, d] ∘GF in[d] for the W column words of one thread;
// src and dst point at row 0, rows n16 words apart.
template <int F, int O, int W>
__device__ __forceinline__ void swar_words(const uint4* __restrict__ src,
                                           uint4* __restrict__ dst,
                                           long long col, int k,
                                           long long n16,
                                           const SwarCoeff& coeff) {
  uint4 acc[O][W];
  swar_column<F, O, W>(WordRows{src, col, n16}, k, coeff, acc);
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long c = word_col(col, j);
      if (c < n16) dst[i * n16 + c] = acc[i][j];
    }
  }
}

// The batch on gridDim.y, columns on x.
template <int F, int O, int W>
__global__ void __launch_bounds__(kThreads)
    gf_swar_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int k, long long n16,
                   const __grid_constant__ SwarCoeff coeff) {
  const long long col = first_col(blockIdx.x, W);
  if (col >= n16) return;
  swar_words<F, O, W>(in + static_cast<long long>(blockIdx.y) * k * n16,
                      out + static_cast<long long>(blockIdx.y) * O * n16,
                      col, k, n16, coeff);
}

// The batch as the fastest block index: blocks b, b+1, ... of one column
// block are neighbours in launch order (tools/exp_batched.py's swapped
// grid, build_batched_swapped).
template <int F, int O, int W>
__global__ void __launch_bounds__(kThreads)
    gf_swar_batch_fastest_kernel(const uint4* __restrict__ in,
                                 uint4* __restrict__ out, int k,
                                 long long n16, int batch,
                                 const __grid_constant__ SwarCoeff coeff) {
  const long long b = blockIdx.x % batch;
  const long long col = first_col(blockIdx.x / batch, W);
  if (col >= n16) return;
  swar_words<F, O, W>(in + b * k * n16, out + b * O * n16, col, k, n16,
                      coeff);
}

// All volumes in one thread: a grid over columns only, each thread walking
// the V volumes of its column words (tools/exp_batched.py's
// _swar_fusedv_kernel, one program for all volumes).
template <int F, int O, int W>
__global__ void __launch_bounds__(kThreads)
    gf_swar_fusedv_kernel(const uint4* __restrict__ in,
                          uint4* __restrict__ out, int k, long long n16,
                          int volumes,
                          const __grid_constant__ SwarCoeff coeff) {
  const long long col = first_col(blockIdx.x, W);
  if (col >= n16) return;
  for (int v = 0; v < volumes; ++v) {
    swar_words<F, O, W>(in + static_cast<long long>(v) * k * n16,
                        out + static_cast<long long>(v) * O * n16, col, k,
                        n16, coeff);
  }
}

// Argument checks shared by the launchers; 0 when the call may go ahead.
int check_args(const void* in, const void* out, int o, int k, long long n16,
               int width, int form, int device) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n16 < 0 ||
      n16 > 0x7fffffffLL * kThreads || !valid_form(o, k, width, form)) {
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

int gf_swar_max_width(int o, int form) { return max_width(o, form); }

const char* gf_swar_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device [batch, k, n16] uint4; out: device [batch, o, n16] uint4;
// coeff: host pointer to gf_swar_coeff_bytes() bytes of SwarCoeff;
// width: column words a thread (1 to gf_swar_max_width(o, form));
// form: 0 for the run-time coefficients, 1 for the compile-time RS(10,4)
// parity (o = 4, k = 10; coeff is then not read);
// stream: a cudaStream_t (0 for the legacy default stream).
int gf_swar_launch(const void* in, void* out, int o, int k, long long n16,
                   int batch, const void* coeff, int width, int form,
                   int device, void* stream) {
  if (batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = check_args(in, out, o, k, n16, width, form, device);
  if (rc || n16 == 0) return rc;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>(column_blocks(n16, width)),
                  static_cast<unsigned>(batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch(form, o, width, [&](auto fc, auto oc, auto wc) {
    gf_swar_kernel<decltype(fc)::value, decltype(oc)::value,
                   decltype(wc)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), k, n16, c);
  });
  return static_cast<int>(cudaGetLastError());
}

// The same product with the batch as the fastest block index (one
// dimension of column blocks x batch).
int gf_swar_batch_fastest_launch(const void* in, void* out, int o, int k,
                                 long long n16, int batch, const void* coeff,
                                 int width, int form, int device,
                                 void* stream) {
  int rc = check_args(in, out, o, k, n16, width, form, device);
  if (rc) return rc;
  const long long blocks = column_blocks(n16, width);
  if (batch < 1 || blocks * batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n16 == 0) return 0;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>(blocks * batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch(form, o, width, [&](auto fc, auto oc, auto wc) {
    gf_swar_batch_fastest_kernel<decltype(fc)::value, decltype(oc)::value,
                                 decltype(wc)::value>
        <<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(in),
                                   static_cast<uint4*>(out), k, n16, batch,
                                   c);
  });
  return static_cast<int>(cudaGetLastError());
}

// The same product over `volumes` volumes in one thread per column words.
int gf_swar_fusedv_launch(const void* in, void* out, int o, int k,
                          long long n16, int volumes, const void* coeff,
                          int width, int form, int device, void* stream) {
  if (volumes < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc = check_args(in, out, o, k, n16, width, form, device);
  if (rc || n16 == 0) return rc;
  SwarCoeff c;
  std::memcpy(&c, coeff, sizeof(c));
  const dim3 grid(static_cast<unsigned>(column_blocks(n16, width)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch(form, o, width, [&](auto fc, auto oc, auto wc) {
    gf_swar_fusedv_kernel<decltype(fc)::value, decltype(oc)::value,
                          decltype(wc)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), k, n16,
        volumes, c);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
