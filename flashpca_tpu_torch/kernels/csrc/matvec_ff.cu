// B4: the two-float (y_hi, y_err) of y = W^T (v_hi + v_lo), with
// W = W_hi + W_lo the exact float64 standardized matrix split into a
// float32 pair.
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_matvec_ff_kernel
// (= _matvec_ff_kernel_for(True)).
//
// Bound: float32 FMAs on the CUDA cores -- three products per genotype
// and column (v_hi W_hi, v_hi W_lo, v_lo W_hi), 6*KC*p*n4 operations.
//
// Design: as matvec.cu (one block = TB packed bytes x all KC columns,
// walking the whole SNP axis; no atomics, no split-K), with the exact
// LUT-select decode of crossprod_ff.cu.  v_hi W_hi is accumulated per
// chunk of CR rows and folded into the running sum with TwoSum; the
// TwoSum errors and the eps-sized v_hi W_lo + v_lo W_hi partials go
// into the err half, which is written out beside the sum.
#include "common.cuh"

namespace {

constexpr int TB = 64;
constexpr int NT = 4 * TB;
constexpr int CR = 64;

template <int KC>
__global__ void __launch_bounds__(NT)
matvec_ff_kernel(const uint8_t* __restrict__ packed,
                 const float* __restrict__ lut6, const float* __restrict__ vh,
                 const float* __restrict__ vl, float* __restrict__ yh,
                 float* __restrict__ yl, long long p, long long nb) {
  __shared__ __align__(16) uint8_t ptile[CR][TB];
  __shared__ __align__(16) float vhtile[CR][KC];
  __shared__ __align__(16) float vltile[CR][KC];
  __shared__ float ltile[CR][6];
  constexpr int V4 = KC / 4;

  const int tid = threadIdx.x;
  const int s = tid / TB;
  const int bb = tid % TB;
  const long long byte0 = static_cast<long long>(blockIdx.x) * TB;
  const long long gb = byte0 + bb;

  float sum[KC], err[KC], acc[KC], accl[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    sum[c] = 0.0f;
    err[c] = 0.0f;
    acc[c] = 0.0f;
    accl[c] = 0.0f;
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
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 b = a;
      if (gr < p) {
        a = reinterpret_cast<const float4*>(vh + gr * KC)[q];
        b = reinterpret_cast<const float4*>(vl + gr * KC)[q];
      }
      reinterpret_cast<float4*>(&vhtile[r][0])[q] = a;
      reinterpret_cast<float4*>(&vltile[r][0])[q] = b;
    }
    for (int idx = tid; idx < CR * 6; idx += NT) {
      const int r = idx / 6;
      const int t = idx % 6;
      const long long gr = r0 + r;
      ltile[r][t] = gr < p ? lut6[t * p + gr] : 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < CR; ++r) {
      const uint32_t code = (static_cast<uint32_t>(ptile[r][bb]) >> (2 * s)) & 3u;
      const float wh = fp::decode_lut(code, ltile[r][0], ltile[r][1], ltile[r][2]);
      const float wl = fp::decode_lut(code, ltile[r][3], ltile[r][4], ltile[r][5]);
      const float4* ah = reinterpret_cast<const float4*>(&vhtile[r][0]);
      const float4* al = reinterpret_cast<const float4*>(&vltile[r][0]);
#pragma unroll
      for (int q = 0; q < V4; ++q) {
        const float4 h = ah[q];
        const float4 l = al[q];
        acc[4 * q + 0] = fmaf(h.x, wh, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(h.y, wh, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h.z, wh, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h.w, wh, acc[4 * q + 3]);
        accl[4 * q + 0] = fmaf(l.x, wh, fmaf(h.x, wl, accl[4 * q + 0]));
        accl[4 * q + 1] = fmaf(l.y, wh, fmaf(h.y, wl, accl[4 * q + 1]));
        accl[4 * q + 2] = fmaf(l.z, wh, fmaf(h.z, wl, accl[4 * q + 2]));
        accl[4 * q + 3] = fmaf(l.w, wh, fmaf(h.w, wl, accl[4 * q + 3]));
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

  if (gb < nb) {
    const long long o = (static_cast<long long>(s) * nb + gb) * KC;
    float4* oh = reinterpret_cast<float4*>(yh + o);
    float4* ol = reinterpret_cast<float4*>(yl + o);
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

// packed (p, nb) u8; lut6 (6, p) f32; vh, vl (p, kc) f32;
// yh, yl (4*nb, kc) f32.
extern "C" int fp_matvec_ff(const void* packed, const void* lut6,
                            const void* vh, const void* vl, void* yh, void* yl,
                            long long p, long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nb + TB - 1) / TB));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* lt = static_cast<const float*>(lut6);
  const auto* a = static_cast<const float*>(vh);
  const auto* b = static_cast<const float*>(vl);
  auto* oh = static_cast<float*>(yh);
  auto* ol = static_cast<float*>(yl);
  switch (kc) {
    case 8: matvec_ff_kernel<8><<<grid, NT, 0, st>>>(pk, lt, a, b, oh, ol, p, nb); break;
    case 16: matvec_ff_kernel<16><<<grid, NT, 0, st>>>(pk, lt, a, b, oh, ol, p, nb); break;
    case 24: matvec_ff_kernel<24><<<grid, NT, 0, st>>>(pk, lt, a, b, oh, ol, p, nb); break;
    case 32: matvec_ff_kernel<32><<<grid, NT, 0, st>>>(pk, lt, a, b, oh, ol, p, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
