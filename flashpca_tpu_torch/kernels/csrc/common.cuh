// Shared device helpers for the packed-genotype kernels.
//
// Build rule: never compile these sources with --use_fast_math.  The
// compensated accumulation (TwoSum) relies on IEEE round-to-nearest
// float addition; the explicit _rn intrinsics below keep the compiler
// from contracting or reassociating the error terms.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp {

// Knuth branch-free TwoSum: s = fl(a + b), and e exact with a + b == s + e.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// Factored-cubic decode of one 2-bit code t: (t - 1)(b0 + t(b1 + t b2)).
// The cubic passes through the four standardized code values; code 1
// (missing) is a structural root, so it decodes to exactly zero however
// the coefficients were rounded.
__device__ __forceinline__ float decode_cubic(uint32_t code, float b0,
                                              float b1, float b2) {
  const float t = static_cast<float>(code);
  return (t - 1.0f) * fmaf(t, fmaf(t, b2, b1), b0);
}

// decode_cubic with each multiply and add rounded on its own, in the order
// of the plain versions' (and the Pallas kernels') elementwise arithmetic
// (t - 1) * (b0 + t * (b1 + t * b2)), so the value is bit-identical to
// theirs.  V3 needs that: a one-ulp change in w can move its bf16 split,
// and with it the ~2^-18 error that the dropped lo * lo term leaves.
__device__ __forceinline__ float decode_cubic_rn(uint32_t code, float b0,
                                                 float b1, float b2) {
  const float t = static_cast<float>(code);
  return __fmul_rn(__fsub_rn(t, 1.0f),
                   __fadd_rn(b0, __fmul_rn(t, __fadd_rn(b1, __fmul_rn(t, b2)))));
}

// Integer-shifted decode: u = code - 1 in int, then u (g0 + u (g1 + u g2))
// with the quadratic through q(u) = w(u) / u at u = -1, 1, 2.  Missing
// (code 1) gives u == 0, so it decodes to exactly zero.
__device__ __forceinline__ float decode_intsub(uint32_t code, float g0,
                                               float g1, float g2) {
  const float u = static_cast<float>(static_cast<int>(code) - 1);
  return u * fmaf(u, fmaf(u, g2, g1), g0);
}

// bf16 hi/lo split, round-to-nearest-even at both steps: hi = rn(a),
// lo = rn(a - hi).  hi + lo carries a to ~2^-16 relative, and a product
// of two bf16 pieces is exact in float32.
__device__ __forceinline__ void split_bf16(float a, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(a);
  lo = __float2bfloat16_rn(__fsub_rn(a, __bfloat162float(hi)));
}

// split_bf16 of two values at once, packed as the mma.sync fragments want
// them (a in the low half): one paired conversion per piece.  Each half
// is bit-identical to split_bf16 of its value.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(a, __low2float(h)), __fsub_rn(b, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Exact per-code select from one SNP's table row (codes 0, 2, 3; code 1
// is missing and always 0).  No arithmetic touches the table values, so
// eps-sized low-half tables survive the decode bit for bit.
__device__ __forceinline__ float decode_lut(uint32_t code, float l0, float l2,
                                            float l3) {
  float v = 0.0f;
  v = (code == 0u) ? l0 : v;
  v = (code == 2u) ? l2 : v;
  v = (code == 3u) ? l3 : v;
  return v;
}

// Four missing codes: a padding byte that decodes to exactly zero.
constexpr uint8_t kMissingByte = 0x55;

// w of the code in bits [sh, sh + 2) of ``word``, from a row's four code
// values t[0..3]: two bit tests and three selects (sh is a constant once
// the loops unroll), no arithmetic, so w is t[code] bit for bit.
__device__ __forceinline__ float pick(uint32_t word, int sh,
                                      const float (&t)[4]) {
  const bool b0 = (word >> sh) & 1u;
  const float lo = b0 ? t[1] : t[0];
  const float hi = b0 ? t[3] : t[2];
  return ((word >> (sh + 1)) & 1u) ? hi : lo;
}

// cp.async staging (sm_80+): copies from global into shared memory that
// run while the block computes; commit a group after issuing, wait for
// all groups, then __syncthreads() before reading what landed.
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One stage of the double-buffered z = W x kernels (B1, B3): a 32-byte
// chunk (128 samples) of TM SNP rows' packed bytes, rows BSTRIDE bytes
// apart, and the chunk's panel rows x[s][j][0..KC) for the 4 planes.
constexpr int kChunkBytes = 32;

template <int TM, int BSTRIDE, int KC>
struct ChunkStage {
  uint8_t bytes[TM][BSTRIDE];
  float x[4][kChunkBytes][KC];
};

// Start the copies of chunk [base, base + 32) of rows [row0, row0 + TM)
// into ``sg``, NT threads sharing them: 16-byte cp.async where the row's
// bytes (``bytes16``) or the panel (``x16``) are 16-byte aligned, plain
// copies where not.  Ragged edges are written with plain stores: byte
// 0x55 (four missing codes) past row p or byte nb, zero panel rows past
// byte nb.
template <int TM, int BSTRIDE, int KC, int NT>
__device__ __forceinline__ void stage_chunk(
    ChunkStage<TM, BSTRIDE, KC>& sg, const uint8_t* __restrict__ packed,
    const float* __restrict__ x, long long p, long long nb, long long row0,
    long long base, bool bytes16, bool x16, int tid) {
  constexpr int CB = kChunkBytes;
  for (int idx = tid; idx < TM * (CB / 16); idx += NT) {
    const int r = idx / (CB / 16);
    const int q = idx % (CB / 16);
    const long long gr = row0 + r;
    const long long gb = base + 16 * q;
    uint8_t* dst = &sg.bytes[r][16 * q];
    if (bytes16 && gr < p && gb + 16 <= nb) {
      cp_async16(dst, packed + gr * nb + gb);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gr < p && gb + e < nb) ? packed[gr * nb + gb + e]
                                         : kMissingByte;
    }
  }
  constexpr int V4 = KC / 4;
  for (int idx = tid; idx < 4 * CB * V4; idx += NT) {
    const int s = idx / (CB * V4);
    const int rem = idx % (CB * V4);
    const int j = rem / V4;
    const int q = rem % V4;
    const long long gb = base + j;
    float* dst = &sg.x[s][j][4 * q];
    if (gb < nb) {
      const float* src = x + (static_cast<long long>(s) * nb + gb) * KC + 4 * q;
      if (x16) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 4; ++e) dst[e] = src[e];
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

}  // namespace fp
