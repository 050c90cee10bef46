// V1, V2 and V4: three measurement variants of B1 (crossprod.cu),
// z = W x, for the kernel sweep (tools/kernel_sweep.py).  The entries
// here are their first designs, fp_crossprod_stacked_v1,
// fp_crossprod_intsub_v1 and fp_crossprod_nocomp_v1, kept for
// comparison: crossprod_variants_v2.cu holds their redesigns on B1's
// second design, bit for bit these sums.
//
// Replaces .claude/skills/verify/kernel_sweep.py::_crossprod_kernel_stacked
// (V1), ::_crossprod_kernel_intsub (V2) and ::_crossprod_kernel_nocomp (V4).
//
// Bound: as B1, float32 FMAs on the CUDA cores (2*KC*p*n4 operations);
// the packed bytes are far below it.
//
// Design: V2 and V4 keep B1's first structure -- one thread per SNP row
// walking the whole byte axis in CB-byte chunks staged in shared memory
// -- and change one thing each.  V2 decodes with u = code - 1 taken in
// int and the g-coefficients (u (g0 + u (g1 + u g2))).  V4 adds each
// chunk's partial into a plain float32 sum, the TPU kernel's `zt += t`:
// no TwoSum and no err.  V1 separates the decode from the FMAs: the
// block first decodes its whole chunk, all four planes, into a (TM, 4*CB)
// float tile in shared memory, then each thread runs one contraction
// over the 4*CB stacked samples of its row (the Hopper reading of the
// TPU kernel's one dot over the concatenated planes); chunks fold with
// TwoSum as in B1.
#include "common.cuh"

namespace {

// ---- V2, V4: B1's structure ------------------------------------------------

constexpr int TM = 256;           // SNP rows per block == threads per block
constexpr int CB = 32;            // packed bytes per chunk (128 samples)
constexpr int PSTRIDE = CB + 4;   // shared row stride: 9 words, odd -> no bank conflicts

template <int KC, bool INTSUB, bool COMP>
__device__ __forceinline__ void rowwise_body(
    const uint8_t* __restrict__ packed, const float* __restrict__ cf0,
    const float* __restrict__ cf1, const float* __restrict__ cf2,
    const float* __restrict__ x, float* __restrict__ z, long long p,
    long long nb) {
  __shared__ __align__(16) uint8_t ptile[TM * PSTRIDE];
  __shared__ __align__(16) float xtile[4][CB][KC];
  constexpr int V4 = KC / 4;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;
  const long long row = row0 + tid;
  const bool live = row < p;
  const float b0 = live ? cf0[row] : 0.0f;
  const float b1 = live ? cf1[row] : 0.0f;
  const float b2 = live ? cf2[row] : 0.0f;

  float sum[KC], err[KC], acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    sum[c] = 0.0f;
    err[c] = 0.0f;
    acc[c] = 0.0f;
  }

  for (long long base = 0; base < nb; base += CB) {
    for (int idx = tid; idx < TM * CB; idx += TM) {
      const int r = idx / CB;
      const int j = idx % CB;
      const long long gr = row0 + r;
      const long long gb = base + j;
      uint8_t v = fp::kMissingByte;
      if (gr < p && gb < nb) v = packed[gr * nb + gb];
      ptile[r * PSTRIDE + j] = v;
    }
    for (int idx = tid; idx < 4 * CB * V4; idx += TM) {
      const int s = idx / (CB * V4);
      const int rem = idx % (CB * V4);
      const int j = rem / V4;
      const int q = rem % V4;
      const long long gb = base + j;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gb < nb)
        v = reinterpret_cast<const float4*>(
            x + (static_cast<long long>(s) * nb + gb) * KC)[q];
      reinterpret_cast<float4*>(&xtile[s][j][0])[q] = v;
    }
    __syncthreads();

    const uint8_t* prow = ptile + tid * PSTRIDE;
    for (int j4 = 0; j4 < CB; j4 += 4) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(prow + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t byte = (word >> (8 * jj)) & 0xffu;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t code = (byte >> (2 * s)) & 3u;
          const float w = INTSUB ? fp::decode_intsub(code, b0, b1, b2)
                                 : fp::decode_cubic(code, b0, b1, b2);
          const float4* xr = reinterpret_cast<const float4*>(&xtile[s][j4 + jj][0]);
#pragma unroll
          for (int q = 0; q < V4; ++q) {
            const float4 xv = xr[q];
            acc[4 * q + 0] = fmaf(w, xv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(w, xv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(w, xv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(w, xv.w, acc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (COMP) {
        float e;
        fp::two_sum(sum[c], acc[c], sum[c], e);
        err[c] = __fadd_rn(err[c], e);
      } else {
        sum[c] = __fadd_rn(sum[c], acc[c]);
      }
      acc[c] = 0.0f;
    }
  }

  if (live) {
    float4* out = reinterpret_cast<float4*>(z + row * KC);
#pragma unroll
    for (int q = 0; q < V4; ++q)
      out[q] = make_float4(sum[4 * q + 0] + err[4 * q + 0],
                           sum[4 * q + 1] + err[4 * q + 1],
                           sum[4 * q + 2] + err[4 * q + 2],
                           sum[4 * q + 3] + err[4 * q + 3]);
  }
}

// V2: B1 with the integer (t - 1) shift; cf0..cf2 hold g0..g2.
template <int KC>
__global__ void __launch_bounds__(TM)
intsub_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ g0,
              const float* __restrict__ g1, const float* __restrict__ g2,
              const float* __restrict__ x, float* __restrict__ z, long long p,
              long long nb) {
  rowwise_body<KC, true, true>(packed, g0, g1, g2, x, z, p, nb);
}

// V4: B1 without the compensation.
template <int KC>
__global__ void __launch_bounds__(TM)
nocomp_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ cf0,
              const float* __restrict__ cf1, const float* __restrict__ cf2,
              const float* __restrict__ x, float* __restrict__ z, long long p,
              long long nb) {
  rowwise_body<KC, false, false>(packed, cf0, cf1, cf2, x, z, p, nb);
}

// ---- V1: decode, then one contraction over the stacked planes --------------

constexpr int S_TM = 128;                  // SNP rows per block == threads per block
constexpr int S_CB = 16;                   // packed bytes per chunk (64 samples)
constexpr int S_PSTRIDE = S_CB + 4;        // 5 words, odd -> no bank conflicts
constexpr int S_WSTRIDE = 4 * S_CB + 1;    // 65 floats, odd -> row reads conflict-free

template <int KC>
__global__ void __launch_bounds__(S_TM)
stacked_kernel(const uint8_t* __restrict__ packed,
               const float* __restrict__ cf0, const float* __restrict__ cf1,
               const float* __restrict__ cf2, const float* __restrict__ x,
               float* __restrict__ z, long long p, long long nb) {
  // 45.5 KB at KC = 32: under the 48 KB of static shared memory
  __shared__ __align__(16) uint8_t ptile[S_TM * S_PSTRIDE];
  __shared__ __align__(16) float xtile[4 * S_CB][KC];   // row s*S_CB + j
  __shared__ float wtile[S_TM * S_WSTRIDE];             // decoded, planes stacked
  __shared__ float ctile[3][S_TM];
  constexpr int V4 = KC / 4;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * S_TM;
  const long long row = row0 + tid;
  const bool live = row < p;
  ctile[0][tid] = live ? cf0[row] : 0.0f;
  ctile[1][tid] = live ? cf1[row] : 0.0f;
  ctile[2][tid] = live ? cf2[row] : 0.0f;

  float sum[KC], err[KC], acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    sum[c] = 0.0f;
    err[c] = 0.0f;
    acc[c] = 0.0f;
  }

  for (long long base = 0; base < nb; base += S_CB) {
    for (int idx = tid; idx < S_TM * S_CB; idx += S_TM) {
      const int r = idx / S_CB;
      const int j = idx % S_CB;
      const long long gr = row0 + r;
      const long long gb = base + j;
      uint8_t v = fp::kMissingByte;
      if (gr < p && gb < nb) v = packed[gr * nb + gb];
      ptile[r * S_PSTRIDE + j] = v;
    }
    for (int idx = tid; idx < 4 * S_CB * V4; idx += S_TM) {
      const int s = idx / (S_CB * V4);
      const int rem = idx % (S_CB * V4);
      const int j = rem / V4;
      const int q = rem % V4;
      const long long gb = base + j;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gb < nb)
        v = reinterpret_cast<const float4*>(
            x + (static_cast<long long>(s) * nb + gb) * KC)[q];
      reinterpret_cast<float4*>(&xtile[s * S_CB + j][0])[q] = v;
    }
    __syncthreads();

    // decode the whole (S_TM, 4 * S_CB) tile: row r, column s * S_CB + j
    for (int idx = tid; idx < S_TM * S_CB; idx += S_TM) {
      const int r = idx / S_CB;
      const int j = idx % S_CB;
      const uint32_t byte = ptile[r * S_PSTRIDE + j];
      const float c0 = ctile[0][r], c1 = ctile[1][r], c2 = ctile[2][r];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wtile[r * S_WSTRIDE + s * S_CB + j] =
            fp::decode_cubic((byte >> (2 * s)) & 3u, c0, c1, c2);
    }
    __syncthreads();

    // one contraction over the 4 * S_CB stacked samples of this row
    const float* wrow = wtile + tid * S_WSTRIDE;
#pragma unroll 4
    for (int c = 0; c < 4 * S_CB; ++c) {
      const float w = wrow[c];
      const float4* xr = reinterpret_cast<const float4*>(&xtile[c][0]);
#pragma unroll
      for (int q = 0; q < V4; ++q) {
        const float4 xv = xr[q];
        acc[4 * q + 0] = fmaf(w, xv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(w, xv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w, xv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w, xv.w, acc[4 * q + 3]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float e;
      fp::two_sum(sum[c], acc[c], sum[c], e);
      err[c] = __fadd_rn(err[c], e);
      acc[c] = 0.0f;
    }
  }

  if (live) {
    float4* out = reinterpret_cast<float4*>(z + row * KC);
#pragma unroll
    for (int q = 0; q < V4; ++q)
      out[q] = make_float4(sum[4 * q + 0] + err[4 * q + 0],
                           sum[4 * q + 1] + err[4 * q + 1],
                           sum[4 * q + 2] + err[4 * q + 2],
                           sum[4 * q + 3] + err[4 * q + 3]);
  }
}

}  // namespace

#define FP_KC_LAUNCH(KERNEL, ROWS)                                          \
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);   \
  const dim3 grid(static_cast<unsigned>((p + (ROWS) - 1) / (ROWS)));       \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
  const auto* pk = static_cast<const uint8_t*>(packed);                    \
  const auto* c0 = static_cast<const float*>(cf0);                         \
  const auto* c1 = static_cast<const float*>(cf1);                         \
  const auto* c2 = static_cast<const float*>(cf2);                         \
  const auto* xx = static_cast<const float*>(x);                           \
  auto* zz = static_cast<float*>(z);                                       \
  switch (kc) {                                                            \
    case 8: KERNEL<8><<<grid, ROWS, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;   \
    case 16: KERNEL<16><<<grid, ROWS, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break; \
    case 24: KERNEL<24><<<grid, ROWS, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break; \
    case 32: KERNEL<32><<<grid, ROWS, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }                                                                        \
  return static_cast<int>(cudaGetLastError());

// All three take B1's arguments: packed (p, nb) u8; cf0..cf2 (p,) f32
// (the g-coefficients for V2); x (4*nb, kc) f32; z (p, kc) f32.
extern "C" int fp_crossprod_stacked_v1(const void* packed, const void* cf0,
                                       const void* cf1, const void* cf2,
                                       const void* x, void* z, long long p,
                                       long long nb, int kc, void* stream) {
  FP_KC_LAUNCH(stacked_kernel, S_TM)
}

extern "C" int fp_crossprod_intsub_v1(const void* packed, const void* cf0,
                                      const void* cf1, const void* cf2,
                                      const void* x, void* z, long long p,
                                      long long nb, int kc, void* stream) {
  FP_KC_LAUNCH(intsub_kernel, TM)
}

extern "C" int fp_crossprod_nocomp_v1(const void* packed, const void* cf0,
                                      const void* cf1, const void* cf2,
                                      const void* x, void* z, long long p,
                                      long long nb, int kc, void* stream) {
  FP_KC_LAUNCH(nocomp_kernel, TM)
}
