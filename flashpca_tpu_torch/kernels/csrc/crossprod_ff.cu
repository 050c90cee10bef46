// B3: the two-float (z_hi, z_err) of z = W x, where W = W_hi + W_lo is
// the exact float64 standardized matrix split into a float32 pair.
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_crossprod_ff_kernel.
//
// Bound: float32 FMAs on the CUDA cores -- two products per genotype
// and column (x W_hi and x W_lo), 4*KC*p*n4 operations.
//
// Design: as crossprod.cu (one block = TM SNP rows x all KC columns,
// walking the whole byte axis; no atomics, no split-K), but the decode
// is an exact per-code select from the six per-SNP table values
// (hi and lo for codes 0, 2, 3), so the lo tables reach the products
// bit for bit.  x W_hi is accumulated per chunk and folded into the
// running sum with TwoSum; the TwoSum errors and the eps-sized x W_lo
// partials go into the err half.  Both halves are written out: the
// next stage (matvec_ff.cu) consumes (z_hi, z_err) as its (v_hi, v_lo).
#include "common.cuh"

namespace {

constexpr int TM = 256;
constexpr int CB = 32;
constexpr int PSTRIDE = CB + 4;

template <int KC>
__global__ void __launch_bounds__(TM)
crossprod_ff_kernel(const uint8_t* __restrict__ packed,
                    const float* __restrict__ lut6,
                    const float* __restrict__ x, float* __restrict__ zh,
                    float* __restrict__ zl, long long p, long long nb) {
  __shared__ __align__(16) uint8_t ptile[TM * PSTRIDE];
  __shared__ __align__(16) float xtile[4][CB][KC];
  constexpr int V4 = KC / 4;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;
  const long long row = row0 + tid;
  const bool live = row < p;
  // lut6 rows: h0, h2, h3, g0, g2, g3 (hi and lo halves), each (p,)
  const float h0 = live ? lut6[0 * p + row] : 0.0f;
  const float h2 = live ? lut6[1 * p + row] : 0.0f;
  const float h3 = live ? lut6[2 * p + row] : 0.0f;
  const float g0 = live ? lut6[3 * p + row] : 0.0f;
  const float g2 = live ? lut6[4 * p + row] : 0.0f;
  const float g3 = live ? lut6[5 * p + row] : 0.0f;

  float sum[KC], err[KC], acc[KC], accl[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    sum[c] = 0.0f;
    err[c] = 0.0f;
    acc[c] = 0.0f;
    accl[c] = 0.0f;
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
          const float wh = fp::decode_lut(code, h0, h2, h3);
          const float wl = fp::decode_lut(code, g0, g2, g3);
          const float4* xr = reinterpret_cast<const float4*>(&xtile[s][j4 + jj][0]);
#pragma unroll
          for (int q = 0; q < V4; ++q) {
            const float4 xv = xr[q];
            acc[4 * q + 0] = fmaf(xv.x, wh, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv.y, wh, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv.z, wh, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv.w, wh, acc[4 * q + 3]);
            accl[4 * q + 0] = fmaf(xv.x, wl, accl[4 * q + 0]);
            accl[4 * q + 1] = fmaf(xv.y, wl, accl[4 * q + 1]);
            accl[4 * q + 2] = fmaf(xv.z, wl, accl[4 * q + 2]);
            accl[4 * q + 3] = fmaf(xv.w, wl, accl[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float e;
      fp::two_sum(sum[c], acc[c], sum[c], e);
      err[c] = __fadd_rn(__fadd_rn(err[c], e), accl[c]);
      acc[c] = 0.0f;
      accl[c] = 0.0f;
    }
  }

  if (live) {
    float4* oh = reinterpret_cast<float4*>(zh + row * KC);
    float4* ol = reinterpret_cast<float4*>(zl + row * KC);
#pragma unroll
    for (int q = 0; q < V4; ++q) {
      oh[q] = make_float4(sum[4 * q + 0], sum[4 * q + 1], sum[4 * q + 2],
                          sum[4 * q + 3]);
      ol[q] = make_float4(err[4 * q + 0], err[4 * q + 1], err[4 * q + 2],
                          err[4 * q + 3]);
    }
  }
}

}  // namespace

// packed (p, nb) u8; lut6 (6, p) f32; x (4*nb, kc) f32; zh, zl (p, kc) f32.
extern "C" int fp_crossprod_ff(const void* packed, const void* lut6,
                               const void* x, void* zh, void* zl, long long p,
                               long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + TM - 1) / TM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* lt = static_cast<const float*>(lut6);
  const auto* xx = static_cast<const float*>(x);
  auto* oh = static_cast<float*>(zh);
  auto* ol = static_cast<float*>(zl);
  switch (kc) {
    case 8: crossprod_ff_kernel<8><<<grid, TM, 0, st>>>(pk, lt, xx, oh, ol, p, nb); break;
    case 16: crossprod_ff_kernel<16><<<grid, TM, 0, st>>>(pk, lt, xx, oh, ol, p, nb); break;
    case 24: crossprod_ff_kernel<24><<<grid, TM, 0, st>>>(pk, lt, xx, oh, ol, p, nb); break;
    case 32: crossprod_ff_kernel<32><<<grid, TM, 0, st>>>(pk, lt, xx, oh, ol, p, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
