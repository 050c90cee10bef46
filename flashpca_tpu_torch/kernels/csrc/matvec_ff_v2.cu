// B4: the two-float (y_hi, y_err) of y = W^T (v_hi + v_lo), with W =
// W_hi + W_lo the exact float64 standardized matrix split into a float32
// pair, selected exactly from each SNP's six table values (code 1,
// missing, decodes to exactly 0).  The polish's and check()'s second
// stage of the wide compensated gram (packed_matvec.py::gram_ff_p).
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_matvec_ff_kernel
// (_matvec_ff_kernel_for(True)).  matvec_ff.cu keeps the first Hopper
// design of this function as fp_matvec_ff_v1, for comparison.
//
// Bound: float32 FMAs on the CUDA cores, three per genotype and column
// (v_hi W_hi, v_hi W_lo, v_lo W_hi): 6*KC*p*n4 operations.  No TF32,
// bf16 split or tensor cores: the check contract needs exact float32
// products.
//
// The sums are bit for bit the first design's.  For each output (sample,
// column) both compute, over the rows r of a 64-row chunk aligned at
// r0 = 0, 64, ... in order, acc = fmaf(vh, wh, acc), then accl =
// fmaf(vh, wl, accl), then accl = fmaf(vl, wh, accl); after each chunk
// two_sum(sum, acc) -> (sum, e) and err = (err + e) + accl, each add
// rounded on its own; and write sum and err.  (wh, wl) is the table pair
// of the sample's code, the same value whether it is selected or loaded.
// Ragged edges take the same padding (byte 0x55, zero v rows and zero
// table rows past p) through the same operations.  Only the mapping of
// outputs to threads, the decode and the staging differ.  That fixes the
// fold points and forbids split-K, another chunk height, folding accl
// into err by FMA (as B5 does) and reordering the three FMAs.
//
// Design (the first design held one sample and all KC columns a thread,
// 4 * KC floats of registers; decoded every row twice through selects;
// fed each v float4 to one sample; and staged synchronously, with two
// barriers a chunk):
// * Thread tile: the four samples of one packed byte x C columns.  One
//   byte load gives the four codes; each staged v_hi / v_lo float4 feeds
//   four samples; each decoded (W_hi, W_lo) pair feeds C columns x 3
//   FFMAs.  A block is TB bytes x 4 planes x KC columns (grid nb / TB,
//   output (4 nb, KC) as before), its KC columns split over KC / C
//   thread groups; the 32 lanes of a warp take 32 consecutive bytes of
//   one column group, so the byte loads are conflict-free and the v loads
//   broadcast.
// * Decode: the chunk's table rows are staged as (hi, lo) float2 pairs
//   indexed by the 2-bit code, code 1 a zero pair, as in
//   matvec_ff_novl.cu, so one 8-byte load at [row][code] decodes a
//   sample exactly.  Per row and thread at C = 8: 96 FFMA, 1 byte load,
//   2 LDS.128 of v_hi, 2 of v_lo and 4 pair loads (the first design: 72
//   FFMA, 6 table loads, 6 selects and 12 v loads per sample and row at
//   KC = 24).
// * Registers and shared memory: acc and accl (8 * C floats) live in
//   registers, since every row updates them; the running sum in shared
//   memory (4 * C floats a thread, thread-fastest, read and written once
//   per chunk by the fold); err in registers (EREG = 1) or beside the sum
//   (EREG = 0).  The row loop is unrolled U rows deep.
// * Staging: double-buffered with cp.async one 64-row chunk at a time
//   (16-byte cp.async.cg for the byte tile and the v_hi / v_lo rows,
//   4-byte cp.async.ca to scatter the table rows into their pairs): the
//   copies of chunk i+1 are in flight while chunk i is computed, with one
//   barrier per chunk.  Rows past p get byte 0x55, zero v rows and zero
//   table rows; bytes past nb get 0x55 and are never written; rows whose
//   bytes are not 16-byte aligned (nb % 16 != 0) are staged byte by byte.
// * Grid and occupancy: without split-K a launch has nb * KC / C
//   threads.  __launch_bounds__ asks for TPS threads an SM.  Production
//   tiles (C, TB, TPS, EREG, U):
//     KC   C  TB   U  threads  TPS  reg. cap  smem KB  blocks/SM  wide   tall
//      8   8  64   8     64    384    168       28         6      2.47   4.95
//     16   8  64   8    128    384    168       44         3      4.95   9.90
//     24   8  64   8    192    384    168       60         2      7.42  14.85
//     32   8  64  16    256    512    128      108         2      7.42  14.85
//   (blocks/SM by threads, the register cap and shared memory, 228 KB an
//   SM less 1 KB a block; the last two columns are waves, blocks / (132
//   SMs x blocks/SM), at nb = 125,440 (wide) and 250,880 (tall).)  On
//   the card the kernel is latency-bound, not issue-bound: 84% of the
//   inner loop's instructions are FFMA, yet with 16 rows unrolled C = 4
//   at twice the warps beat C = 8; 8 rows unrolled beat 16 at kc 16
//   and 24, and C = 4 at kc 24 (at the 168-register cap 16 rows leave
//   less room for loads in flight).  TB = 128 runs best on the tall bytes but, one block an
//   SM, loses the wide launch's last part-wave.  The tiles tried are in
//   PERF.md.
//
// A source that defines MATVEC_FF_TILE_<KC> as "C, TB, TPS, EREG, U" and
// then includes this one builds B4 at another tile: tools/b4_tiles.py
// times other tiles that way.
#include "common.cuh"

#ifndef MATVEC_FF_TILE_8
#define MATVEC_FF_TILE_8 8, 64, 384, 1, 8
#endif
#ifndef MATVEC_FF_TILE_16
#define MATVEC_FF_TILE_16 8, 64, 384, 1, 8
#endif
#ifndef MATVEC_FF_TILE_24
#define MATVEC_FF_TILE_24 8, 64, 384, 1, 8
#endif
#ifndef MATVEC_FF_TILE_32
#define MATVEC_FF_TILE_32 8, 64, 512, 0, 16
#endif

namespace {

namespace mff2 {

constexpr int CR = 64;  // SNP rows a chunk: one stage, one fold (the first
                        // design's, which sets the fold points)
constexpr int LW = 8;   // staged table row: (hi, lo) for codes 0..3

// One stage of the double buffer: a chunk's byte tile, v_hi and v_lo
// rows and table rows.
template <int KC, int TB>
struct Stage {
  uint8_t bytes[CR][TB];
  float vh[CR][KC];
  float vl[CR][KC];
  float lut[CR][LW];
};

// A tile: C columns a thread, TB bytes a block, TPS threads an SM, err in
// registers (EREG) or in shared memory, U rows unrolled; threads per
// block and the dynamic shared memory: two stages, then the running sums
// (and errs).
template <int KC_, int C_, int TB_, int TPS_, int EREG_, int U_>
struct Shape {
  static constexpr int KC = KC_, C = C_, TB = TB_, TPS = TPS_, U = U_;
  static constexpr bool EREG = EREG_ != 0;
  static_assert(KC % C == 0 && C % 4 == 0, "C must divide KC, 4 | C");
  static_assert(TB % 32 == 0, "a warp takes 32 bytes");
  static_assert(CR % U == 0, "U must divide the chunk's rows");
  static constexpr int NT = TB * (KC / C);
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int SMEM =
      2 * sizeof(Stage<KC, TB>) + (EREG ? 1 : 2) * 4 * C * NT * 4;
};

template <int KC>
struct Tile;
template <>
struct Tile<8> : Shape<8, MATVEC_FF_TILE_8> {};
template <>
struct Tile<16> : Shape<16, MATVEC_FF_TILE_16> {};
template <>
struct Tile<24> : Shape<24, MATVEC_FF_TILE_24> {};
template <>
struct Tile<32> : Shape<32, MATVEC_FF_TILE_32> {};

// Start the copies of chunk rows [r0, r0 + CR) into stage ``sg``.
template <int KC, int TB, int NT>
__device__ __forceinline__ void stage_chunk(
    Stage<KC, TB>& sg, const uint8_t* __restrict__ packed,
    const float* __restrict__ lut6, const float* __restrict__ vh,
    const float* __restrict__ vl, long long p, long long nb, long long byte0,
    long long r0, bool bytes16, bool v16, int tid) {
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
  // v_hi rows, then v_lo rows
  constexpr int GV = KC / 4;
  for (int idx = tid; idx < 2 * CR * GV; idx += NT) {
    const int half = idx / (CR * GV);
    const int r = idx % (CR * GV) / GV;
    const int q = idx % GV;
    const long long gr = r0 + r;
    const float* src = (half ? vl : vh) + gr * KC + 4 * q;
    float* dst = half ? &sg.vl[r][4 * q] : &sg.vh[r][4 * q];
    if (v16 && gr < p) {
      fp::cp_async16(dst, src);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = gr < p ? src[e] : 0.0f;
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

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
matvec_ff_tile_kernel(const uint8_t* __restrict__ packed,
                      const float* __restrict__ lut6,
                      const float* __restrict__ vh,
                      const float* __restrict__ vl, float* __restrict__ yh,
                      float* __restrict__ yl, long long p, long long nb,
                      bool bytes16, bool v16) {
  using T = Tile<KC>;
  constexpr int C = T::C;
  constexpr int TB = T::TB;
  constexpr int NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<KC, TB>* sg = reinterpret_cast<Stage<KC, TB>*>(smem);
  // sum (and, without EREG, err) of output (s, c) of thread tid at
  // [(s * C + c) * NT + tid]: read and written once per chunk, by the fold
  float* ssum = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<KC, TB>));
  float* serr = ssum + 4 * C * NT;

  const int tid = threadIdx.x;
  const int bb = tid % TB;
  const int cg = tid / TB;
  const long long byte0 = static_cast<long long>(blockIdx.x) * TB;

  float acc[4][C], accl[4][C], err[4][C];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ssum[(s * C + c) * NT + tid] = 0.0f;
      if constexpr (!T::EREG) serr[(s * C + c) * NT + tid] = 0.0f;
      err[s][c] = 0.0f;
      acc[s][c] = 0.0f;
      accl[s][c] = 0.0f;
    }
  }
  for (int idx = tid; idx < 2 * CR; idx += NT) {
    float* pair = &sg[idx / CR].lut[idx % CR][2];
    pair[0] = 0.0f;
    pair[1] = 0.0f;
  }

  const long long nchunk = (p + CR - 1) / CR;
  stage_chunk<KC, TB, NT>(sg[0], packed, lut6, vh, vl, p, nb, byte0, 0,
                          bytes16, v16, tid);
  fp::cp_async_commit();
  for (long long i = 0; i < nchunk; ++i) {
    // chunk i has landed for every thread, and every thread is done
    // with chunk i - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nchunk)
      stage_chunk<KC, TB, NT>(sg[(i + 1) & 1], packed, lut6, vh, vl, p, nb,
                              byte0, (i + 1) * CR, bytes16, v16, tid);
    fp::cp_async_commit();

    const Stage<KC, TB>& cur = sg[i & 1];
    // the chunk's rows in order, U at a time
#pragma unroll 1
    for (int r0 = 0; r0 < CR; r0 += T::U) {
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        const int r = r0 + u;
        const uint32_t byte = cur.bytes[r][bb];
        const float4* hr =
            reinterpret_cast<const float4*>(&cur.vh[r][cg * C]);
        const float4* lr =
            reinterpret_cast<const float4*>(&cur.vl[r][cg * C]);
        float h[C], l[C];
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 a = hr[q];
          const float4 b = lr[q];
          h[4 * q + 0] = a.x;
          h[4 * q + 1] = a.y;
          h[4 * q + 2] = a.z;
          h[4 * q + 3] = a.w;
          l[4 * q + 0] = b.x;
          l[4 * q + 1] = b.y;
          l[4 * q + 2] = b.z;
          l[4 * q + 3] = b.w;
        }
        const float2* pairs =
            reinterpret_cast<const float2*>(&cur.lut[r][0]);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float2 w = pairs[(byte >> (2 * s)) & 3u];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[s][c] = fmaf(h[c], w.x, acc[s][c]);
            accl[s][c] = fmaf(h[c], w.y, accl[s][c]);
            accl[s][c] = fmaf(l[c], w.x, accl[s][c]);
          }
        }
      }
    }

#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (s * C + c) * NT + tid;
        float t, e;
        fp::two_sum(ssum[o], acc[s][c], t, e);
        ssum[o] = t;
        if constexpr (T::EREG)
          err[s][c] = __fadd_rn(__fadd_rn(err[s][c], e), accl[s][c]);
        else
          serr[o] = __fadd_rn(__fadd_rn(serr[o], e), accl[s][c]);
        acc[s][c] = 0.0f;
        accl[s][c] = 0.0f;
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
        float hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = (s * C + 4 * q + j) * NT + tid;
          hi[j] = ssum[idx];
          lo[j] = T::EREG ? err[s][4 * q + j] : serr[idx];
        }
        oh[q] = make_float4(hi[0], hi[1], hi[2], hi[3]);
        ol[q] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* lt, const float* a,
              const float* b, float* oh, float* ol, long long p, long long nb,
              bool bytes16, bool v16, cudaStream_t st) {
  using T = Tile<KC>;
  cudaError_t rc = cudaFuncSetAttribute(
      matvec_ff_tile_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(matvec_ff_tile_kernel<KC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((nb + T::TB - 1) / T::TB));
  matvec_ff_tile_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, lt, a, b, oh, ol, p, nb, bytes16, v16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mff2

}  // namespace

// B4. packed (p, nb) u8; lut6 (6, p) f32; vh, vl (p, kc) f32;
// yh, yl (4*nb, kc) f32.
extern "C" int fp_matvec_ff(const void* packed, const void* lut6,
                            const void* vh, const void* vl, void* yh, void* yl,
                            long long p, long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* lt = static_cast<const float*>(lut6);
  const auto* a = static_cast<const float*>(vh);
  const auto* b = static_cast<const float*>(vl);
  auto* oh = static_cast<float*>(yh);
  auto* ol = static_cast<float*>(yl);
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool v16 = reinterpret_cast<uintptr_t>(vh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vl) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(yh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(yl) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return mff2::launch_kc<8>(pk, lt, a, b, oh, ol, p, nb, bytes16, v16, st);
    case 16: return mff2::launch_kc<16>(pk, lt, a, b, oh, ol, p, nb, bytes16, v16, st);
    case 24: return mff2::launch_kc<24>(pk, lt, a, b, oh, ol, p, nb, bytes16, v16, st);
    case 32: return mff2::launch_kc<32>(pk, lt, a, b, oh, ol, p, nb, bytes16, v16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
