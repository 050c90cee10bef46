// B2: y = W^T v, the permuted-sample-space product of the packed
// standardized genotype matrix W (p SNPs x n4 samples) with an
// SNP-space panel v (p x KC).
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_matvec_kernel.
//
// Bound: float32 FMAs on the CUDA cores (2*KC*p*n4 operations against
// 12.6 GB of packed bytes at the headline shape).
//
// Design: one block owns TB packed bytes -- 4*TB output samples, thread
// (s, b) owning sample plane s of byte b -- times all KC columns, and
// walks the WHOLE SNP axis itself (no atomics, no split-K).  Per chunk
// of CR SNP rows the block stages the packed tile, the v rows and the
// rows' cubic coefficients in shared memory; a warp reads 32
// consecutive bytes of one row (no bank conflicts) and broadcasts the v
// row into KC FMAs.  Each chunk's partial is folded into a running
// (sum, err) pair with TwoSum, as in crossprod.cu.
#include "common.cuh"

namespace {

constexpr int TB = 64;            // packed bytes per block
constexpr int NT = 4 * TB;        // threads: 4 sample planes x TB bytes
constexpr int CR = 64;            // SNP rows per chunk

template <int KC>
__global__ void __launch_bounds__(NT)
matvec_kernel(const uint8_t* __restrict__ packed,
              const float* __restrict__ cf0, const float* __restrict__ cf1,
              const float* __restrict__ cf2, const float* __restrict__ v,
              float* __restrict__ y, long long p, long long nb) {
  __shared__ __align__(16) uint8_t ptile[CR][TB];
  __shared__ __align__(16) float vtile[CR][KC];
  __shared__ float ctile[CR][3];
  constexpr int V4 = KC / 4;

  const int tid = threadIdx.x;
  const int s = tid / TB;
  const int bb = tid % TB;
  const long long byte0 = static_cast<long long>(blockIdx.x) * TB;
  const long long gb = byte0 + bb;

  float sum[KC], err[KC], acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    sum[c] = 0.0f;
    err[c] = 0.0f;
    acc[c] = 0.0f;
  }

  for (long long r0 = 0; r0 < p; r0 += CR) {
    for (int idx = tid; idx < CR * TB; idx += NT) {
      const int r = idx / TB;
      const int j = idx % TB;
      const long long gr = r0 + r;
      const long long gj = byte0 + j;
      uint8_t val = fp::kMissingByte;
      if (gr < p && gj < nb) val = packed[gr * nb + gj];
      ptile[r][j] = val;
    }
    for (int idx = tid; idx < CR * V4; idx += NT) {
      const int r = idx / V4;
      const int q = idx % V4;
      const long long gr = r0 + r;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gr < p) val = reinterpret_cast<const float4*>(v + gr * KC)[q];
      reinterpret_cast<float4*>(&vtile[r][0])[q] = val;
    }
    for (int r = tid; r < CR; r += NT) {
      const long long gr = r0 + r;
      const bool ok = gr < p;
      ctile[r][0] = ok ? cf0[gr] : 0.0f;
      ctile[r][1] = ok ? cf1[gr] : 0.0f;
      ctile[r][2] = ok ? cf2[gr] : 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < CR; ++r) {
      const uint32_t byte = ptile[r][bb];
      const float w = fp::decode_cubic((byte >> (2 * s)) & 3u, ctile[r][0],
                                       ctile[r][1], ctile[r][2]);
      const float4* vr = reinterpret_cast<const float4*>(&vtile[r][0]);
#pragma unroll
      for (int q = 0; q < V4; ++q) {
        const float4 vv = vr[q];
        acc[4 * q + 0] = fmaf(w, vv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(w, vv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w, vv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w, vv.w, acc[4 * q + 3]);
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

  if (gb < nb) {
    float4* out = reinterpret_cast<float4*>(
        y + (static_cast<long long>(s) * nb + gb) * KC);
#pragma unroll
    for (int q = 0; q < V4; ++q)
      out[q] = make_float4(sum[4 * q + 0] + err[4 * q + 0],
                           sum[4 * q + 1] + err[4 * q + 1],
                           sum[4 * q + 2] + err[4 * q + 2],
                           sum[4 * q + 3] + err[4 * q + 3]);
  }
}

}  // namespace

// packed (p, nb) u8; cf0..cf2 (p,) f32; v (p, kc) f32; y (4*nb, kc) f32.
extern "C" int fp_matvec(const void* packed, const void* cf0, const void* cf1,
                         const void* cf2, const void* v, void* y, long long p,
                         long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nb + TB - 1) / TB));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* c0 = static_cast<const float*>(cf0);
  const auto* c1 = static_cast<const float*>(cf1);
  const auto* c2 = static_cast<const float*>(cf2);
  const auto* vv = static_cast<const float*>(v);
  auto* yy = static_cast<float*>(y);
  switch (kc) {
    case 8: matvec_kernel<8><<<grid, NT, 0, st>>>(pk, c0, c1, c2, vv, yy, p, nb); break;
    case 16: matvec_kernel<16><<<grid, NT, 0, st>>>(pk, c0, c1, c2, vv, yy, p, nb); break;
    case 24: matvec_kernel<24><<<grid, NT, 0, st>>>(pk, c0, c1, c2, vv, yy, p, nb); break;
    case 32: matvec_kernel<32><<<grid, NT, 0, st>>>(pk, c0, c1, c2, vv, yy, p, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
