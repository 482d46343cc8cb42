// GF(2^8)/0x11d matrix product straight from u8 shard rows in device
// memory, of any width and any row stride, for Hopper (sm_90a).
//
//   out[b, i, c] = XOR_d  C[i, d] ∘GF in[b, d, c]      i < O, d < k, c < n
//
// Replaces the TPU kernel seaweedfs_tpu/ops/pallas/gf_kernel.py
// _swar_u8_kernel, reached through _gf_matmul_swar_u8_device (method
// "swar" on a device-u8 slab). The algebra is gf_swar.cu's, from the one
// copy in gf_swar_column.cuh: four bytes to a u32 and the byte-parallel
// doubling, one doubling per coefficient bit, XOR into every output whose
// coefficient has that bit. The TPU kernel regroups each row's bytes into
// u32 lanes with an in-VMEM bitcast; here a thread groups 16 consecutive
// bytes into four u32 in registers (any grouping gives the same bytes,
// since the arithmetic is byte-wise).
//
// What makes it a route of its own: it takes the rows as they lie. A
// ragged tail is read and written byte by byte with a mask, and rows may
// be a strided view (the first 10 rows of a [14, N] shard tensor), so the
// route makes no padding copy; the reference pads with jnp.pad
// (_pad_and_run) and gf_swar.py pads to 16 bytes with F.pad.
//
// What bounds it on an H100 SXM, and the design. Per u32 word of the
// RS(10,4) parity it moves 56 bytes (ten read, four written) and does 60
// doublings (180 ALU-pipe instructions) and the XORs. With run-time
// coefficients those XORs are predicated and issue whether or not the bit
// is set, 280 a word, so the ALU pipe bounds the product well above its
// bytes: this kernel's first design, one word a thread and run-time
// coefficients only, ran at 46 % of its byte bound. Now:
//
// - The compile-time RS(10,4) parity (gf_swar_column.cuh: rs10x4_coef) for
//    a coefficient the wrapper marks as that matrix: only the XORs of set
//    bits exist, folded into three-input LOP3s, about 255 ALU-pipe
//    instructions a word in all, so HBM3 bounds the parity (0.2805 ms at
//    [10, 64 MiB] against 0.256 ms of issue). At W = 1 alone: W = 2
//    measured slower (PERF.md).
// - The run-time SwarCoeff form for every other matrix (the
//    reconstructions, other RS shapes), still bound by ALU issue, with
//    W = 2 column words a thread where the wrapper's plan says so: each
//    per-bit test serves two words.
// - Two load paths, chosen once a thread. Where all of a thread's words
//    are whole and the rows and pointer 16-byte aligned, straight-line
//    16-byte loads (WholeRows) that ptxas issues ahead of the algebra, as
//    in gf_swar; else each word through gf_common.cuh's load_bytes<16>,
//    which moves a whole aligned word in one load and a partial or
//    unaligned one byte by byte (ByteRows). With the masked path inline in
//    every row the parity ran 15 % behind gf_swar's on the same bytes.
//    Stores split the same way (store_bytes<16> for the rest).
// - Word j of a thread is column col + j * kThreads (16 bytes a column),
//    so each warp instruction stays coalesced; a word past the row width
//    is masked.
//
// Limits: O <= 16, k <= 64, batch <= 65535. The launcher allocates
// nothing, launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "gf_swar_column.cuh"

namespace {

// Row d's W words of strided rows where all of them are whole and the rows
// 16-byte aligned: one 16-byte load each, no mask.
struct WholeRows {
  const uint8_t* src;  // row 0 of this batch entry
  long long rs;        // row stride in bytes
  long long col;       // the thread's first column word

  template <int W>
  __device__ __forceinline__ void operator()(int d, uint4 (&x)[W]) const {
    const uint8_t* row = src + d * rs;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long at = 16 * word_col(col, j);
      x[j] = __ldg(reinterpret_cast<const uint4*>(row + at));
    }
  }
};

// Row d's W words of strided u8 rows: the 16 bytes of column word j, of
// which those past the row's n bytes read as 0.
struct ByteRows {
  const uint8_t* src;  // row 0 of this batch entry
  long long rs, n;     // row stride and row width in bytes
  long long col;       // the thread's first column word
  bool vec;            // pointer and strides 16-byte aligned

  template <int W>
  __device__ __forceinline__ void operator()(int d, uint4 (&x)[W]) const {
    const uint8_t* row = src + d * rs;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long at = 16 * word_col(col, j);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (at < n) load_bytes<16>(row + at, n - at, vec, w);
      x[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// The batch on gridDim.y, column words on x.
template <int F, int O, int W>
__global__ void __launch_bounds__(kThreads)
    gf_swar_u8_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int k, const Layout L,
                      const __grid_constant__ SwarCoeff coeff) {
  const long long col = first_col(blockIdx.x, W);
  if (16 * col >= L.n) return;
  const uint8_t* src = in + blockIdx.y * L.in_bs;
  uint8_t* dst = out + blockIdx.y * L.out_bs;
  // one test for the thread, the same for all its rows: are its words
  // all whole? Then aligned rows take straight-line 16-byte loads, which
  // ptxas can issue ahead of the algebra as it does gf_swar's
  const bool whole = 16 * word_col(col, W - 1) + 16 <= L.n;
  uint4 acc[O][W];
  if (whole && L.in_vec) {
    swar_column<F, O, W>(WholeRows{src, L.in_rs, col}, k, coeff, acc);
  } else {
    swar_column<F, O, W>(ByteRows{src, L.in_rs, L.n, col, L.in_vec}, k,
                         coeff, acc);
  }
  if (whole && L.out_vec) {
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        *reinterpret_cast<uint4*>(dst + i * L.out_rs +
                                  16 * word_col(col, j)) = acc[i][j];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long at = 16 * word_col(col, j);
      if (at < L.n) {
        const uint32_t w[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z,
                               acc[i][j].w};
        store_bytes<16>(dst + i * L.out_rs + at, w, L.n - at, L.out_vec);
      }
    }
  }
}

}  // namespace

extern "C" {

int gf_swar_u8_coeff_bytes() { return static_cast<int>(sizeof(SwarCoeff)); }

int gf_swar_u8_max_width(int o, int form) { return max_width(o, form); }

const char* gf_swar_u8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: device u8 [batch, k, >= n] with byte strides (in_bs, in_rs);
// out: device u8 [batch, o, >= n] with byte strides (out_bs, out_rs);
// width: column words a thread (1 to gf_swar_u8_max_width(o, form));
// form: 0 for the run-time coefficients, 1 for the compile-time RS(10,4)
// parity (o = 4, k = 10; coeff is then not read);
// coeff: host pointer to gf_swar_u8_coeff_bytes() bytes of SwarCoeff.
int gf_swar_u8_launch(const void* in, void* out, int o, int k, long long n,
                      int width, int form, int batch, long long in_bs,
                      long long in_rs, long long out_bs, long long out_rs,
                      const void* coeff, int device, void* stream) {
  if (o < 1 || o > kMaxOut || k < 1 || k > kMaxIn || n < 0 || batch < 1 ||
      batch > 65535 || !valid_form(o, k, width, form) ||
      column_blocks((n + 15) / 16, width) > 0x7fffffffLL) {
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
  const dim3 grid(static_cast<unsigned>(column_blocks((n + 15) / 16, width)),
                  static_cast<unsigned>(batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch(form, o, width, [&](auto fc, auto oc, auto wc) {
    gf_swar_u8_kernel<decltype(fc)::value, decltype(oc)::value,
                      decltype(wc)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), k, L,
        c);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
