// B1: z = W x, the SNP-space product of the packed standardized
// genotype matrix W (p SNPs x n4 permuted samples) with a panel x.
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_crossprod_kernel.
//
// Bound: float32 FMAs on the CUDA cores.  Each packed byte feeds
// 4 samples x KC columns of FMAs, so at the solver's panel widths the
// operation count (2*KC*p*n4) outweighs the 12.6 GB of packed bytes by
// far at the full-f32 rate (no TF32: the check contract needs full
// float32 products).
//
// Design: one block owns TM SNP rows and all KC panel columns and walks
// the WHOLE byte axis itself, so nothing is carried between blocks (no
// atomics, no split-K: the result is deterministic and the compensation
// exact).  Per chunk of CB bytes the block stages the packed tile and
// the matching x rows (all 4 sample planes) in shared memory; each
// thread owns one SNP row, decodes its bytes with the factored cubic and
// broadcasts x rows from shared memory into KC FMAs per sample.  The
// chunk's plain float32 partial is folded into a running (sum, err)
// pair with TwoSum, so the accumulated error stays ~eps of the result
// instead of growing with the 5e5-long contraction.
#include "common.cuh"

namespace {

constexpr int TM = 256;           // SNP rows per block == threads per block
constexpr int CB = 32;            // packed bytes per chunk (128 samples)
constexpr int PSTRIDE = CB + 4;   // shared row stride: 9 words, odd -> no bank conflicts

template <int KC>
__global__ void __launch_bounds__(TM)
crossprod_kernel(const uint8_t* __restrict__ packed,
                 const float* __restrict__ cf0, const float* __restrict__ cf1,
                 const float* __restrict__ cf2, const float* __restrict__ x,
                 float* __restrict__ z, long long p, long long nb) {
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
    // packed tile: TM rows x CB bytes, consecutive threads on consecutive bytes
    for (int idx = tid; idx < TM * CB; idx += TM) {
      const int r = idx / CB;
      const int j = idx % CB;
      const long long gr = row0 + r;
      const long long gb = base + j;
      uint8_t v = fp::kMissingByte;
      if (gr < p && gb < nb) v = packed[gr * nb + gb];
      ptile[r * PSTRIDE + j] = v;
    }
    // x tile: 4 planes x CB samples x KC columns, as float4
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
          const float w = fp::decode_cubic((byte >> (2 * s)) & 3u, b0, b1, b2);
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

// packed (p, nb) u8; cf0..cf2 (p,) f32; x (4*nb, kc) f32; z (p, kc) f32.
extern "C" int fp_crossprod(const void* packed, const void* cf0,
                            const void* cf1, const void* cf2, const void* x,
                            void* z, long long p, long long nb, int kc,
                            void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + TM - 1) / TM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* c0 = static_cast<const float*>(cf0);
  const auto* c1 = static_cast<const float*>(cf1);
  const auto* c2 = static_cast<const float*>(cf2);
  const auto* xx = static_cast<const float*>(x);
  auto* zz = static_cast<float*>(z);
  switch (kc) {
    case 8: crossprod_kernel<8><<<grid, TM, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 16: crossprod_kernel<16><<<grid, TM, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 24: crossprod_kernel<24><<<grid, TM, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 32: crossprod_kernel<32><<<grid, TM, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
