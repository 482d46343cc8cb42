// The SWAR column algebra of gf_swar.cu and gf_swar_u8.cu: the two
// coefficient forms, the column words a thread takes, and the column body
// swar_column<F, O, W> behind a loader that fills input row d's W words.
// A kernel brings its own loader (gf_swar: whole uint4 words of packed
// rows; gf_swar_u8: strided u8 rows, whole words or a masked ragged tail)
// and stores the accumulators itself. Included by those two sources; build.py hashes it
// with each.
//
// The algebra: four shard bytes sit in each u32, and multiplying them by 2
// in the field is the byte-parallel xtime of gf_common.cuh. For each input
// row the column doubles the word once per coefficient bit and XORs it into
// every output accumulator whose coefficient has that bit.
//
// - The compile-time form holds the one matrix every ec.encode launch uses,
//   the RS(10,4) parity (rs10x4_coef). Each row, bit and output is a
//   template argument, so only the XORs of set bits exist, and ptxas folds
//   two into one three-input LOP3 (75 a word in gf_swar's SASS, where the
//   run-time form issues 280 predicated ones).
// - The run-time form takes any matrix in the SwarCoeff kernel argument:
//   its per-bit test reads the struct, the same for the whole warp, so it
//   never diverges, but compiles to predicated XORs that issue whether or
//   not the bit is set. W column words a thread share each test.
// - Word j of a thread is column col + j * kThreads, so each load and store
//   instruction of a warp stays coalesced; a loader masks words past the
//   row.

#pragma once

#include <utility>

#include "gf_common.cuh"

namespace {

// The coefficient forms (the launchers' `form` argument).
constexpr int kRunTime = 0;  // the SwarCoeff kernel argument: any matrix
constexpr int kRs10x4 = 1;   // the RS(10,4) parity as compile-time constants

constexpr int kRsOut = 4;
constexpr int kRsIn = 10;

// C[i][d] of gf256.parity_matrix(10, 4), the parity rows of ec.encode.
__host__ __device__ constexpr unsigned rs10x4_coef(int i, int d) {
  constexpr unsigned char kRs10x4Parity[kRsOut][kRsIn] = {
      {0x81, 0x96, 0xaf, 0xb8, 0xd2, 0xc4, 0xfe, 0xe8, 0x03, 0x02},
      {0x96, 0x81, 0xb8, 0xaf, 0xc4, 0xd2, 0xe8, 0xfe, 0x02, 0x03},
      {0xbf, 0xd6, 0x62, 0x0a, 0x06, 0x6f, 0xdf, 0xb7, 0x05, 0x04},
      {0xd6, 0xbf, 0x0a, 0x62, 0x6f, 0x06, 0xb7, 0xdf, 0x04, 0x05},
  };
  return kRs10x4Parity[i][d];
}

// The bits input row d of the parity needs: the bit length of its column.
__host__ __device__ constexpr int rs10x4_top(int d) {
  unsigned c = 0;
  for (int i = 0; i < kRsOut; ++i) c |= rs10x4_coef(i, d);
  int top = 0;
  for (; c; c >>= 1) ++top;
  return top;
}

// The widest W of a form: in the run-time form 2 for up to 4 outputs,
// whose 8 accumulator words stay in registers (at 7 outputs ptxas
// spilled; W = 4 measured slower than 2); the compile-time form has no
// per-bit tests to share among words, and measured slower at W = 2 in
// both kernels (PERF.md): W = 1 alone.
constexpr int max_width(int o, int form) {
  return form == kRunTime && o <= 4 ? 2 : 1;
}

// The form and width are a launch the kernels instantiate.
constexpr bool valid_form(int o, int k, int width, int form) {
  return (form == kRs10x4 ? (o == kRsOut && k == kRsIn) : form == kRunTime)
         && width >= 1 && width <= max_width(o, form);
}

// Word j of the thread whose first word is column `col`.
__device__ __forceinline__ long long word_col(long long col, int j) {
  return col + static_cast<long long>(j) * kThreads;
}

// The first column of the thread in column block `block`.
__device__ __forceinline__ long long first_col(long long block, int width) {
  return block * kThreads * width + threadIdx.x;
}

// Column blocks of a launch of n16 column words, W a thread.
inline long long column_blocks(long long n16, int width) {
  const long long per_block = static_cast<long long>(kThreads) * width;
  return (n16 + per_block - 1) / per_block;
}

template <int W>
__device__ __forceinline__ void double_words(uint4 (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = xtime4(x[j]);
}

template <int W>
__device__ __forceinline__ void xor_words(uint4 (&acc)[W],
                                          const uint4 (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) xor_into(acc[j], x[j]);
}

// Run-time form: row x through its `top` bits, XORed where mask[b] says.
template <int O, int W>
__device__ __forceinline__ void fold_row(uint4 (&acc)[O][W], uint4 (&x)[W],
                                         int top, const uint16_t (&mask)[8]) {
  for (int b = 0; b < top; ++b) {
    if (b) double_words(x);
    const unsigned m = mask[b];
#pragma unroll
    for (int i = 0; i < O; ++i) {
      if (m & (1u << i)) xor_words(acc[i], x);
    }
  }
}

// Compile-time form: every row, bit and output is a template argument, so
// only the XORs of set bits exist.
template <bool On, int W>
__device__ __forceinline__ void xor_if(uint4 (&acc)[W], const uint4 (&x)[W]) {
  if constexpr (On) xor_words(acc, x);
}

template <int D, int B, int O, int W, int... I>
__device__ __forceinline__ void xor_bit(uint4 (&acc)[O][W],
                                        const uint4 (&x)[W],
                                        std::integer_sequence<int, I...>) {
  (xor_if<((rs10x4_coef(I, D) >> B) & 1u) != 0, W>(acc[I], x), ...);
}

template <int D, int O, int W, int... B>
__device__ __forceinline__ void fold_row_rs(uint4 (&acc)[O][W], uint4 (&x)[W],
                                            std::integer_sequence<int, B...>) {
  ((B ? double_words(x) : void(),
    xor_bit<D, B, O, W>(acc, x, std::make_integer_sequence<int, O>{})),
   ...);
}

// Row D of the parity: load it, then fold it through its bits.
template <int D, int O, int W, typename Load>
__device__ __forceinline__ void rs_row(const Load& load, uint4 (&acc)[O][W]) {
  uint4 x[W];
  load(D, x);
  fold_row_rs<D, O, W>(acc, x,
                       std::make_integer_sequence<int, rs10x4_top(D)>{});
}

template <int O, int W, typename Load, int... D>
__device__ __forceinline__ void rs_rows(const Load& load, uint4 (&acc)[O][W],
                                        std::integer_sequence<int, D...>) {
  (rs_row<D, O, W>(load, acc), ...);
}

// acc[i] = XOR_d C[i, d] ∘GF in[d] for the W column words of one thread;
// load(d, x) fills x with input row d's W words (0 for a word past the
// row), called once per row that feeds an output.
template <int F, int O, int W, typename Load>
__device__ __forceinline__ void swar_column(const Load& load, int k,
                                            const SwarCoeff& coeff,
                                            uint4 (&acc)[O][W]) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = make_uint4(0u, 0u, 0u, 0u);
  }

  if constexpr (F == kRs10x4) {
    rs_rows<O, W>(load, acc, std::make_integer_sequence<int, kRsIn>{});
  } else {
    for (int d = 0; d < k; ++d) {
      const int top = coeff.top[d];
      if (top == 0) continue;
      uint4 x[W];
      load(d, x);
      fold_row<O, W>(acc, x, top, coeff.mask[d]);
    }
  }
}

template <int V>
using IntC = std::integral_constant<int, V>;

// f(form, O, W) as integral constants for a (form, o, width) that
// valid_form accepted.
template <typename Fn>
void dispatch(int form, int o, int width, Fn&& f) {
  if (form == kRs10x4) {
    f(IntC<kRs10x4>{}, IntC<kRsOut>{}, IntC<1>{});
    return;
  }
  dispatch_out(o, [&](auto oc) {
    constexpr int O = decltype(oc)::value;
    if constexpr (max_width(O, kRunTime) >= 2) {
      if (width == 2) return f(IntC<kRunTime>{}, oc, IntC<2>{});
    }
    f(IntC<kRunTime>{}, oc, IntC<1>{});
  });
}

}  // namespace
