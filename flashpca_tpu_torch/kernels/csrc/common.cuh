// Shared device helpers for the packed-genotype kernels.
//
// Build rule: never compile these sources with --use_fast_math.  The
// compensated accumulation (TwoSum) relies on IEEE round-to-nearest
// float addition; the explicit _rn intrinsics below keep the compiler
// from contracting or reassociating the error terms.
#pragma once

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

}  // namespace fp
