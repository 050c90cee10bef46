// B5: the two-float (y_hi, y_err) of y = W^T v_h, with W = W_hi + W_lo
// the exact float64 standardized matrix split into a float32 pair,
// selected exactly from each SNP's six table values (code 1, missing,
// decodes to exactly 0).  v_h W_hi is accumulated in full float32 FMAs
// per chunk of CR SNP rows and folded into the running sum with TwoSum;
// the TwoSum errors and v_h W_lo go into the err half.  Stage 1 of the
// tall compensated gram (packed_matvec.py::gram_tall_ff_p).
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_matvec_ff_kernel_novl
// (_matvec_ff_kernel_for(False)).  matvec_ff.cu keeps the first Hopper
// design of this function as fp_matvec_ff_novl_v1, for comparison.
//
// Bound: float32 FMAs on the CUDA cores, two per genotype and column
// (v_h W_hi, v_h W_lo): 4*KC*p*n4 operations.  No TF32, bf16 split or
// tensor cores: the tall gram is held to 1.5e-7 of float64, and the
// products must be exact float32 FMAs for that.
//
// Design (the first design lost to registers, shared-memory traffic and
// exposed staging):
// * Thread tile: the four samples of one packed byte x C columns.  One
//   byte load gives the four codes; each decoded (W_hi, W_lo) pair feeds
//   C columns and each staged v_h float4 feeds four samples.  A block is
//   TB bytes x 4 planes x KC columns (grid nb / TB, output (4 nb, KC) as
//   before), its KC columns split over KC / C thread groups; the 32
//   lanes of a warp take 32 consecutive bytes of one column group, so
//   the byte loads are conflict-free and the v_h loads broadcast.
// * Decode: the chunk's table rows are staged as (hi, lo) float2 pairs
//   indexed by the 2-bit code, code 1 a zero pair, so one 8-byte load
//   at [row][code] decodes a sample's W_hi and W_lo exactly.  The four
//   codes of a warp land on four distinct banks.  Per row and thread at
//   C = 8: 1 byte load, 2 float4 loads of v_h, 4 pair loads -- 7
//   shared-memory instructions and no selects per 64 FFMAs (the first
//   design: 15 loads and 6 selects per 64).
// * Registers: err and the chunk partial acc, 2 * 4 * C floats (64 at
//   C = 8), independent of KC; v_h W_lo goes by FMA straight into err
//   (no separate low-half accumulator).  The running sum lives in
//   shared memory (4 * C floats a thread, laid out thread-fastest), read
//   and written once per chunk by the fold: with sum in registers too,
//   ptxas spilled at the 128-register cap.  __launch_bounds__ asks for
//   512 threads per SM where the block size divides it: at KC = 8, 16
//   and 32 that caps a thread at 128 registers and 16 warps share an SM
//   (the first design: 208 registers at KC = 32, 8 warps).  At KC = 24 a
//   block is 192 threads and asks for two blocks per SM, 12 warps (cap
//   170 registers; three blocks would allow at most 112).  Shared
//   memory: 61,440 bytes a block at KC = 32 and CR = 64 (two stages and
//   the sums), dynamic, so two blocks fit an SM.
// * Staging: double-buffered with cp.async (16-byte cp.async.cg for the
//   byte tile and the v_h rows, 4-byte cp.async.ca to scatter the table
//   rows into their pairs): the copies of chunk i+1 are in flight while
//   chunk i is computed, with one barrier per chunk.  Ragged edges keep
//   the first design's rule -- the all-missing byte 0x55, zero v_h rows,
//   zero table rows -- with plain stores; rows whose bytes are not
//   16-byte aligned (nb % 16 != 0) are staged byte by byte.  The inner
//   loop is unrolled 16 rows deep (chip_smoke.py prints its SASS mix:
//   per row 64 FFMA, 7 LDS, 4 SHF and 4 LOP3).
//
// C and CR are template parameters: production runs (C_PROD, CR_PROD)
// through fp_matvec_ff_novl.  matvec_ff_novl_variants.cu includes this
// file with MATVEC_FF_NOVL_NO_ENTRY defined and builds the other tiles
// that chip_smoke.py compares, in a library of their own.
#include "common.cuh"

namespace {

constexpr int TB = 64;       // packed bytes per block (x 4 sample planes)
constexpr int C_PROD = 8;    // columns per thread in production
constexpr int CR_PROD = 64;  // SNP rows per chunk: one stage, one fold
constexpr int LW = 8;        // staged table row: (hi, lo) for codes 0..3

// One stage of the double buffer: a chunk's byte tile, v_h rows and
// table rows.
template <int KC, int CR>
struct Stage {
  uint8_t bytes[CR][TB];
  float v[CR][KC];
  float lut[CR][LW];
};

// Start the copies of chunk rows [r0, r0 + CR) into stage ``sg``.
template <int KC, int NT, int CR>
__device__ __forceinline__ void stage_chunk(
    Stage<KC, CR>& sg, const uint8_t* __restrict__ packed,
    const float* __restrict__ lut6, const float* __restrict__ vh, long long p,
    long long nb, long long byte0, long long r0, bool bytes16, bool v16,
    int tid) {
  constexpr int GB = TB / 16;
  for (int idx = tid; idx < CR * GB; idx += NT) {
    const int r = idx / GB;
    const int q = idx % GB;
    const long long gr = r0 + r;
    const long long gj = byte0 + 16 * q;
    uint8_t* dst = &sg.bytes[r][16 * q];
    if (bytes16 && gr < p && gj + 16 <= nb) {
      fp::cp_async16(dst, packed + gr * nb + gj);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gr < p && gj + e < nb) ? packed[gr * nb + gj + e]
                                         : fp::kMissingByte;
    }
  }
  constexpr int GV = KC / 4;
  for (int idx = tid; idx < CR * GV; idx += NT) {
    const int r = idx / GV;
    const int q = idx % GV;
    const long long gr = r0 + r;
    float* dst = &sg.v[r][4 * q];
    if (v16 && gr < p) {
      fp::cp_async16(dst, vh + gr * KC + 4 * q);
    } else {
      for (int e = 0; e < 4; ++e)
        dst[e] = gr < p ? vh[gr * KC + 4 * q + e] : 0.0f;
    }
  }
  // lut6 rows t = 0..5 hold [hi0, hi2, hi3, lo0, lo2, lo3]; the pair of
  // code c sits at lut[r][2c] (hi) and lut[r][2c + 1] (lo).  Code 1's
  // pair is zeroed once per kernel and never copied into.
  for (int idx = tid; idx < 6 * CR; idx += NT) {
    const int t = idx / CR;
    const int r = idx % CR;
    const long long gr = r0 + r;
    const int code = (t % 3 == 0) ? 0 : t % 3 + 1;
    float* dst = &sg.lut[r][2 * code + t / 3];
    if (gr < p) {
      fp::cp_async4(dst, lut6 + t * p + gr);
    } else {
      *dst = 0.0f;
    }
  }
}

// Threads per block, the blocks per SM that __launch_bounds__ asks for
// (as many as fit in 512 threads: 128 registers a thread where NT
// divides 512, 170 at KC / C = 3), and the dynamic shared memory: two
// stages and the running sums.
template <int KC, int C, int CR>
struct Tile {
  static constexpr int NT = TB * (KC / C);
  static constexpr int MIN_BLOCKS = 512 / NT > 0 ? 512 / NT : 1;
  static constexpr int SMEM = 2 * sizeof(Stage<KC, CR>) + 4 * C * NT * 4;
};

template <int KC, int C, int CR>
__global__ void __launch_bounds__(Tile<KC, C, CR>::NT,
                                  Tile<KC, C, CR>::MIN_BLOCKS)
matvec_ff_novl_kernel(const uint8_t* __restrict__ packed,
                      const float* __restrict__ lut6,
                      const float* __restrict__ vh, float* __restrict__ yh,
                      float* __restrict__ yl, long long p, long long nb,
                      bool bytes16, bool v16) {
  static_assert(KC % C == 0 && C % 4 == 0, "C must divide KC, 4 | C");
  constexpr int NT = Tile<KC, C, CR>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<KC, CR>* sg = reinterpret_cast<Stage<KC, CR>*>(smem);
  // sum[s][c] of thread tid at ssum[(s * C + c) * NT + tid]
  float* ssum = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<KC, CR>));

  const int tid = threadIdx.x;
  const int bb = tid % TB;
  const int cg = tid / TB;
  const long long byte0 = static_cast<long long>(blockIdx.x) * TB;

  float err[4][C], acc[4][C];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ssum[(s * C + c) * NT + tid] = 0.0f;
      err[s][c] = 0.0f;
      acc[s][c] = 0.0f;
    }
  }
  for (int idx = tid; idx < 2 * CR; idx += NT) {
    float* pair = &sg[idx / CR].lut[idx % CR][2];
    pair[0] = 0.0f;
    pair[1] = 0.0f;
  }

  const long long nchunk = (p + CR - 1) / CR;
  stage_chunk<KC, NT, CR>(sg[0], packed, lut6, vh, p, nb, byte0, 0, bytes16,
                          v16, tid);
  fp::cp_async_commit();
  for (long long i = 0; i < nchunk; ++i) {
    // chunk i has landed for every thread, and every thread is done
    // with chunk i - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nchunk)
      stage_chunk<KC, NT, CR>(sg[(i + 1) & 1], packed, lut6, vh, p, nb,
                              byte0, (i + 1) * CR, bytes16, v16, tid);
    fp::cp_async_commit();

    const Stage<KC, CR>& cur = sg[i & 1];
#pragma unroll 16
    for (int r = 0; r < CR; ++r) {
      const uint32_t byte = cur.bytes[r][bb];
      const float4* vr = reinterpret_cast<const float4*>(&cur.v[r][cg * C]);
      float v[C];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 a = vr[q];
        v[4 * q + 0] = a.x;
        v[4 * q + 1] = a.y;
        v[4 * q + 2] = a.z;
        v[4 * q + 3] = a.w;
      }
      const float2* pairs = reinterpret_cast<const float2*>(&cur.lut[r][0]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 w = pairs[(byte >> (2 * s)) & 3u];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[s][c] = fmaf(v[c], w.x, acc[s][c]);
          err[s][c] = fmaf(v[c], w.y, err[s][c]);
        }
      }
    }

#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float* sum = &ssum[(s * C + c) * NT + tid];
        float t, e;
        fp::two_sum(*sum, acc[s][c], t, e);
        *sum = t;
        err[s][c] = __fadd_rn(err[s][c], e);
        acc[s][c] = 0.0f;
      }
    }
  }

  const long long gb = byte0 + bb;
  if (gb < nb) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const long long o = (static_cast<long long>(s) * nb + gb) * KC + cg * C;
      float4* oh = reinterpret_cast<float4*>(yh + o);
      float4* ol = reinterpret_cast<float4*>(yl + o);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float* sum = &ssum[(s * C + 4 * q) * NT + tid];
        oh[q] = make_float4(sum[0], sum[NT], sum[2 * NT], sum[3 * NT]);
        ol[q] = make_float4(err[s][4 * q + 0], err[s][4 * q + 1],
                            err[s][4 * q + 2], err[s][4 * q + 3]);
      }
    }
  }
}

template <int KC, int C, int CR>
int launch_kc(const uint8_t* pk, const float* lt, const float* a, float* oh,
              float* ol, long long p, long long nb, bool bytes16, bool v16,
              cudaStream_t st) {
  using T = Tile<KC, C, CR>;
  const cudaError_t rc = cudaFuncSetAttribute(
      matvec_ff_novl_kernel<KC, C, CR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((nb + TB - 1) / TB));
  matvec_ff_novl_kernel<KC, C, CR><<<grid, T::NT, T::SMEM, st>>>(
      pk, lt, a, oh, ol, p, nb, bytes16, v16);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int CR>
int launch(const void* packed, const void* lut6, const void* vh, void* yh,
           void* yl, long long p, long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* lt = static_cast<const float*>(lut6);
  const auto* a = static_cast<const float*>(vh);
  auto* oh = static_cast<float*>(yh);
  auto* ol = static_cast<float*>(yl);
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool v16 = reinterpret_cast<uintptr_t>(vh) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(yh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(yl) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8:
      return launch_kc<8, C, CR>(pk, lt, a, oh, ol, p, nb, bytes16, v16, st);
    case 16:
      return launch_kc<16, C, CR>(pk, lt, a, oh, ol, p, nb, bytes16, v16, st);
    case 24:
      return launch_kc<24, C, CR>(pk, lt, a, oh, ol, p, nb, bytes16, v16, st);
    case 32:
      return launch_kc<32, C, CR>(pk, lt, a, oh, ol, p, nb, bytes16, v16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#ifndef MATVEC_FF_NOVL_NO_ENTRY
// B5. packed (p, nb) u8; lut6 (6, p) f32; vh (p, kc) f32;
// yh, yl (4*nb, kc) f32.
extern "C" int fp_matvec_ff_novl(const void* packed, const void* lut6,
                                 const void* vh, void* yh, void* yl,
                                 long long p, long long nb, int kc,
                                 void* stream) {
  return launch<C_PROD, CR_PROD>(packed, lut6, vh, yh, yl, p, nb, kc, stream);
}
#endif
