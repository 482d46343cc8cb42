// What the port's GF(2^8) kernels share: the coefficient struct, the SWAR
// doubling, byte-masked loads and stores of rows of any width, the 4x4 byte
// transpose of the tile-local repack, and the dispatch of a run-time output
// count to a template. Included by the sources in this directory; build.py
// hashes it with each of them.

#pragma once

#include <cstdint>
#include <type_traits>

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

// Rows addressed by byte strides: [batch, rows, >= n].
struct Layout {
  long long n;             // row width in bytes
  long long in_bs, in_rs;  // byte strides of the input batch and rows
  long long out_bs, out_rs;
  bool in_vec, out_vec;    // aligned to the access width: whole words move
};

// Byte-parallel doubling of four packed bytes in GF(2^8)/0x11d.
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

// B bytes (16, 8 or 4) at p into B/4 little-endian words; of them `avail`
// exist, the rest read as 0. Whole words move when `vec` (p aligned to B).
template <int B>
__device__ __forceinline__ void load_bytes(const uint8_t* p, long long avail,
                                           bool vec, uint32_t (&w)[B / 4]) {
  if (vec && avail >= B) {
    if constexpr (B == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (B == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
    return;
  }
  // the ragged tail: bytes one at a time into an array of its own, so the
  // run-time index touches only it and w stays in registers
  uint32_t t[B / 4] = {};
  for (int i = 0; i < B && i < avail; ++i) {
    t[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
  }
#pragma unroll
  for (int i = 0; i < B / 4; ++i) w[i] = t[i];
}

// The first `avail` of B bytes, given as B/4 little-endian words, to p.
template <int B>
__device__ __forceinline__ void store_bytes(uint8_t* p,
                                            const uint32_t (&w)[B / 4],
                                            long long avail, bool vec) {
  if (vec && avail >= B) {
    if constexpr (B == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (B == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned int*>(p) = w[0];
    }
    return;
  }
  uint32_t t[B / 4];
#pragma unroll
  for (int i = 0; i < B / 4; ++i) t[i] = w[i];
  for (int i = 0; i < B && i < avail; ++i) {
    p[i] = static_cast<uint8_t>(t[i >> 2] >> (8 * (i & 3)));
  }
}

// a[s] holds bytes 4m..4m+3 of quarter s; o[m] gets byte m of each quarter.
// A 4x4 byte transpose, so it is its own inverse.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t& o0, uint32_t& o1,
                                           uint32_t& o2, uint32_t& o3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t t1 = __byte_perm(a2, a3, 0x5140);  // a2.0 a3.0 a2.1 a3.1
  const uint32_t t2 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);  // a2.2 a3.2 a2.3 a3.3
  o0 = __byte_perm(t0, t1, 0x5410);
  o1 = __byte_perm(t0, t1, 0x7632);
  o2 = __byte_perm(t2, t3, 0x5410);
  o3 = __byte_perm(t2, t3, 0x7632);
}

// p and the two strides are multiples of `to` (a power of two).
inline bool aligned(const void* p, long long a, long long b, int to) {
  return ((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(a) |
           static_cast<uintptr_t>(b)) & static_cast<uintptr_t>(to - 1)) == 0;
}

// f(std::integral_constant<int, O>) for the run-time output count o;
// false when o is outside 1..kMaxOut.
template <typename F>
bool dispatch_out(int o, F&& f) {
  switch (o) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    case 9: f(std::integral_constant<int, 9>{}); return true;
    case 10: f(std::integral_constant<int, 10>{}); return true;
    case 11: f(std::integral_constant<int, 11>{}); return true;
    case 12: f(std::integral_constant<int, 12>{}); return true;
    case 13: f(std::integral_constant<int, 13>{}); return true;
    case 14: f(std::integral_constant<int, 14>{}); return true;
    case 15: f(std::integral_constant<int, 15>{}); return true;
    case 16: f(std::integral_constant<int, 16>{}); return true;
    default: return false;
  }
}

}  // namespace
