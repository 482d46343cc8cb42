// Tile-local byte repack of shard rows into u32 words, and its inverse, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels seaweedfs_tpu/ops/pallas/gf_kernel.py
// _repack_block_kernel (gf_repack) and _unpack_block_kernel (gf_unpack),
// which _build_u8_repack_chain puts around the u32 swar kernel. Per tile of
// T bytes of a row, with q = T / 4, the reference reshapes u8 [k, T] to
// [4k, q] and bitcasts four sublanes into one u32, so
//
//   word[t*q + j] = in[t*T + j]         | in[t*T +   q + j] << 8
//                 | in[t*T + 2q + j] << 16 | in[t*T + 3q + j] << 24
//
// (quarter s lands in byte s, as the reference's kernel run in interpret
// mode shows). gf_unpack is the exact inverse.
//
// On Hopper this is a byte permutation, bound by bytes: each byte is read
// once and written once. The vector path gives a thread 16 words of one
// tile: it loads one 16-byte word from each of the four quarters, turns
// each 4x4 byte block around with __byte_perm (PRMT; transpose4 of
// gf_common.cuh), and stores 64 bytes
// as four 16-byte stores; neighbouring threads take neighbouring words, so
// loads and stores are coalesced. It needs q % 16 == 0 (T a multiple of
// 64) and 16-byte aligned rows; otherwise a scalar path gives a thread one
// word. Bytes past the row's width n read as 0 (the reference pads with
// jnp.pad), so the caller makes no padding copy, and gf_unpack writes only
// the first n bytes of each output row.
//
// Layout: rows addressed by (batch, row) strides, bytes for u8 tensors and
// words for u32 ones. The launchers allocate nothing, launch on the
// caller's stream and return cudaGetLastError().

#include "gf_common.cuh"

namespace {

__device__ __forceinline__ uint8_t byte_at(const uint8_t* row, long long c,
                                           long long n) {
  return c < n ? row[c] : 0;
}

struct Rows {
  int rows;                      // rows per batch item
  long long in_bs, in_rs;        // strides of the input
  long long out_bs, out_rs;      // strides of the output
};

// ---- repack: u8 [.., n] -> u32 [.., n4], n4 = tiles * q ----------------

__global__ void __launch_bounds__(kThreads)
    repack_vec(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
               long long n, long long n4, long long q, Rows r) {
  const long long unit =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long w0 = unit * 16;  // first of this thread's 16 words
  if (w0 >= n4) return;
  const int b = blockIdx.y / r.rows, row = blockIdx.y % r.rows;
  const uint8_t* src = in + b * r.in_bs + row * r.in_rs;
  uint32_t* dst = out + b * r.out_bs + row * r.out_rs + w0;
  const long long t = w0 / q, j = w0 % q;
  const long long c0 = t * 4 * q + j;
  uint32_t a[4][4];  // a[s]: the 16 bytes of quarter s
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long long c = c0 + s * q;
    if (c < n) {
      load_bytes<16>(src + c, n - c, true, a[s]);
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) a[s][g] = 0u;
    }
  }
  uint4 o[4];
  transpose4(a[0][0], a[1][0], a[2][0], a[3][0], o[0].x, o[0].y, o[0].z,
             o[0].w);
  transpose4(a[0][1], a[1][1], a[2][1], a[3][1], o[1].x, o[1].y, o[1].z,
             o[1].w);
  transpose4(a[0][2], a[1][2], a[2][2], a[3][2], o[2].x, o[2].y, o[2].z,
             o[2].w);
  transpose4(a[0][3], a[1][3], a[2][3], a[3][3], o[3].x, o[3].y, o[3].z,
             o[3].w);
#pragma unroll
  for (int m = 0; m < 4; ++m) reinterpret_cast<uint4*>(dst)[m] = o[m];
}

__global__ void __launch_bounds__(kThreads)
    repack_scalar(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                  long long n, long long n4, long long q, Rows r) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= n4) return;
  const int b = blockIdx.y / r.rows, row = blockIdx.y % r.rows;
  const uint8_t* src = in + b * r.in_bs + row * r.in_rs;
  const long long c0 = (w / q) * 4 * q + w % q;
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v |= static_cast<uint32_t>(byte_at(src, c0 + s * q, n)) << (8 * s);
  }
  out[b * r.out_bs + row * r.out_rs + w] = v;
}

// ---- unpack: u32 [.., n4] -> u8 [.., n], n <= n4 * 4 -------------------

__global__ void __launch_bounds__(kThreads)
    unpack_vec(const uint32_t* __restrict__ in, uint8_t* __restrict__ out,
               long long n, long long n4, long long q, Rows r) {
  const long long unit =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long w0 = unit * 16;
  if (w0 >= n4) return;
  const long long t = w0 / q, j = w0 % q;
  const long long c0 = t * 4 * q + j;
  if (c0 >= n) return;  // quarter 0 holds the lowest columns of the words
  const int b = blockIdx.y / r.rows, row = blockIdx.y % r.rows;
  const uint4* src =
      reinterpret_cast<const uint4*>(in + b * r.in_bs + row * r.in_rs + w0);
  uint8_t* dst = out + b * r.out_bs + row * r.out_rs;
  uint4 u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) u[m] = __ldg(src + m);
  uint32_t o[4][4];  // o[s]: the 16 bytes of quarter s
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    transpose4(u[m].x, u[m].y, u[m].z, u[m].w, o[0][m], o[1][m], o[2][m],
               o[3][m]);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long long c = c0 + s * q;
    if (c < n) store_bytes<16>(dst + c, o[s], n - c, true);
  }
}

__global__ void __launch_bounds__(kThreads)
    unpack_scalar(const uint32_t* __restrict__ in, uint8_t* __restrict__ out,
                  long long n, long long n4, long long q, Rows r) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= n4) return;
  const int b = blockIdx.y / r.rows, row = blockIdx.y % r.rows;
  const uint32_t v = in[b * r.in_bs + row * r.in_rs + w];
  uint8_t* dst = out + b * r.out_bs + row * r.out_rs;
  const long long c0 = (w / q) * 4 * q + w % q;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long long c = c0 + s * q;
    if (c < n) dst[c] = static_cast<uint8_t>(v >> (8 * s));
  }
}

int check_args(int batch, int rows, long long n, long long n4, long long q) {
  if (batch < 1 || rows < 1 || static_cast<long long>(batch) * rows > 65535 ||
      n < 0 || q < 1 || n4 < 0 || n4 % q != 0 || n > 4 * n4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

const char* gf_repack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: u8 [batch, rows, >= n] (byte strides); out: u32 [batch, rows, >= n4]
// (word strides); n4 = tiles * q words, tile T = 4q bytes.
int gf_repack_launch(const void* in, void* out, int batch, int rows,
                     long long n, long long n4, long long q, long long in_bs,
                     long long in_rs, long long out_bs, long long out_rs,
                     int device, void* stream) {
  int rc = check_args(batch, rows, n, n4, q);
  if (rc) return rc;
  if (n4 == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Rows r{rows, in_bs, in_rs, out_bs, out_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = q % 16 == 0 && aligned(in, in_bs, in_rs, 16) &&
                   aligned(out, 4 * out_bs, 4 * out_rs, 16);
  const long long units = vec ? n4 / 16 : n4;
  const dim3 grid(static_cast<unsigned>((units + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch * rows));
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (vec) {
    repack_vec<<<grid, kThreads, 0, s>>>(src, dst, n, n4, q, r);
  } else {
    repack_scalar<<<grid, kThreads, 0, s>>>(src, dst, n, n4, q, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// in: u32 [batch, rows, >= n4] (word strides); out: u8 [batch, rows, >= n]
// (byte strides); writes the first n bytes of each output row.
int gf_unpack_launch(const void* in, void* out, int batch, int rows,
                     long long n, long long n4, long long q, long long in_bs,
                     long long in_rs, long long out_bs, long long out_rs,
                     int device, void* stream) {
  int rc = check_args(batch, rows, n, n4, q);
  if (rc) return rc;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Rows r{rows, in_bs, in_rs, out_bs, out_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = q % 16 == 0 && aligned(in, 4 * in_bs, 4 * in_rs, 16) &&
                   aligned(out, out_bs, out_rs, 16);
  const long long units = vec ? n4 / 16 : n4;
  const dim3 grid(static_cast<unsigned>((units + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch * rows));
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (vec) {
    unpack_vec<<<grid, kThreads, 0, s>>>(src, dst, n, n4, q, r);
  } else {
    unpack_scalar<<<grid, kThreads, 0, s>>>(src, dst, n, n4, q, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
