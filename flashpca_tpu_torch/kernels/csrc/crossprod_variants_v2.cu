// V1, V2 and V4 on B1's design (crossprod_v2.cu): three measurement
// variants of B1, z = W x, for the kernel sweep (tools/kernel_sweep.py),
// each differing from B1 in the one thing it isolates.
//
// Replaces .claude/skills/verify/kernel_sweep.py::_crossprod_kernel_stacked
// (V1), ::_crossprod_kernel_intsub (V2) and ::_crossprod_kernel_nocomp
// (V4).  crossprod_variants.cu keeps their first designs as
// fp_crossprod_stacked_v1, fp_crossprod_intsub_v1 and
// fp_crossprod_nocomp_v1, for comparison.
//
// Bound: as B1, float32 FMAs on the CUDA cores, 2*KC*p*n4 operations (the
// packed bytes take a fifth of that time at the memory rate).  No TF32,
// bf16 split or tensor cores.
//
// The sums are bit for bit the first designs'.  For each output z[row, c]:
// * V4 (nocomp): acc = fmaf(w(row, j, s), x[s][j][c], acc) over the bytes
//   j of a 32-byte chunk in order and, within a byte, the planes s = 0..3;
//   sum = __fadd_rn(sum, acc) at the chunk's end; no err.
// * V2 (intsub): B1's order -- V4's FMAs, then two_sum(sum, acc) and err
//   += e at the chunk's end; sum + err at the end -- with w decoded by
//   fp::decode_intsub (u = code - 1 in int and the g-coefficients).
// * V1 (stacked): per 16-byte chunk (64 samples) the stacked order
//   s * 16 + j -- the planes s = 0..3 and, within a plane, the chunk's
//   bytes j in order; acc = fmaf(w, x, acc); two_sum(sum, acc) and
//   err += e at the chunk's end; sum + err at the end.
// V1 and V4 decode with fp::decode_cubic (missing decodes to exactly 0 in
// both decodes) and all three keep the first designs' ragged edges: byte
// 0x55 and zero x rows.
//
// Design: B1's.  A block of TM SNP rows (B1's 128); a thread tile of R
// rows x C columns, the 32 lanes of a warp on 32 consecutive rows of one
// column group, so each float4 of x is a broadcast; each row's four decoded
// values fp::decode_cubic(t, b0, b1, b2) (V2: fp::decode_intsub(t, g0,
// g1, g2)), t = 0..3, computed once a kernel and a sample's w picked from
// them (fp::pick: the same float as decoding at every sample); cp.async
// double buffering of 32-byte chunks (fp::stage_chunk); the per-KC launch
// table.
// V2 and V4 instantiate B1's own loop (b1::body in b1_tile.cuh, which
// crossprod_v2.cu instantiates as B1), V2 at B1's own tile (b1::Tile),
// so neither can drift from B1.
// * V2 is B1 with the other decode: B1's kernel, its tile at every KC
//   (the sum in shared memory, err in registers), and only the row
//   values' arithmetic changed.  Since a sample's w is picked, that
//   arithmetic runs 4 times a row and kernel, so V2's time beside B1's
//   in one run is what the decode's form costs once it is picked.
// * V4 is B1 without the compensation: no err registers and no TwoSum,
//   one __fadd_rn a chunk into the running sum, kept in registers
//   (SREG = 1) or, as B1 keeps it, in shared memory (SREG = 0).  Its
//   time beside B1's in one run is what the compensation costs B1.
// * V1 separates the decode from the contraction: the Hopper reading of
//   the TPU kernel's one dot over the concatenated planes.  For each
//   16-byte half of a staged chunk the block decodes its TM rows once
//   into a float tile W of TM rows x 64 stacked samples in shared memory
//   (rows WSTRIDE = 68 floats apart, so that a quarter-warp's 16-byte
//   reads and writes of 8 consecutive rows hit distinct banks).  A unit
//   of that decode is one row's 16 bytes at one plane, picked from the
//   row's four values (in shared memory).  Then the threads of every
//   column group run their R x C FFMA tile over the 64 samples: one
//   LDS.128 of 4 consecutive stacked samples of each of its rows against
//   broadcast float4s of x.  The decode is done once a block, not once a
//   column group; the price is a shared load per 4 samples and row and a
//   barrier between decode and contraction.  WBUF = 2 keeps both halves'
//   W tiles (decode both, one barrier, two contractions: two barriers a
//   chunk); WBUF = 1 one tile (four barriers a chunk, 34 KB less at TM =
//   128).  U of the contraction's four planes are unrolled.  The running
//   sum is in shared memory, as B1's.  Over 48 KB of shared memory:
//   dynamic, raised with cudaFuncSetAttribute.
//   A half that lies wholly past byte nb is skipped: the first design has
//   no such chunk (and its fold would add exact zeros).
//
// A source that defines CROSSPROD_NOCOMP_TILE_<KC> as "R, C, TPS, SREG"
// or CROSSPROD_STACKED_TILE_<KC> as "TM, R, C, TPS, WBUF, U" (TPS: the
// threads an SM that __launch_bounds__ asks for) and then includes this one
// builds V4 or V1 at another tile: tools/variant_tiles.py times other
// tiles that way.  The production tiles below: V4 takes B1's at every KC
// (its sum in shared memory, as B1's), so that it differs from B1 in the
// compensation alone; V1 at KC = 16, the sweep's width, takes the fastest
// shape tried there (4 rows x 4 columns a thread, 128 rows a block; how
// many planes are unrolled made no difference beyond the run-to-run
// spread); its other KCs are untimed.  V2 takes B1's tile (b1::Tile) at
// every KC and has no macro: it is not tiled apart from B1.  The tiles
// tried and their times are in PERF.md.
#include "b1_tile.cuh"

#ifndef CROSSPROD_NOCOMP_TILE_8
#define CROSSPROD_NOCOMP_TILE_8 2, 8, 768, 0
#endif
#ifndef CROSSPROD_NOCOMP_TILE_16
#define CROSSPROD_NOCOMP_TILE_16 2, 8, 768, 0
#endif
#ifndef CROSSPROD_NOCOMP_TILE_24
#define CROSSPROD_NOCOMP_TILE_24 2, 12, 384, 0
#endif
#ifndef CROSSPROD_NOCOMP_TILE_32
#define CROSSPROD_NOCOMP_TILE_32 2, 16, 384, 0
#endif
#ifndef CROSSPROD_STACKED_TILE_8
#define CROSSPROD_STACKED_TILE_8 128, 2, 4, 384, 1, 4
#endif
#ifndef CROSSPROD_STACKED_TILE_16
#define CROSSPROD_STACKED_TILE_16 128, 4, 4, 384, 1, 1
#endif
#ifndef CROSSPROD_STACKED_TILE_24
#define CROSSPROD_STACKED_TILE_24 128, 2, 12, 256, 1, 4
#endif
#ifndef CROSSPROD_STACKED_TILE_32
#define CROSSPROD_STACKED_TILE_32 128, 2, 16, 256, 1, 4
#endif

namespace {

namespace var2 {

using b1::BSTRIDE;
using b1::CB;
using b1::Shape;
using b1::Stage;
using b1::row_values;
using b1::write_out;

constexpr int HB = 16;               // bytes a V1 fold (64 stacked samples)
constexpr int WSTRIDE = 4 * HB + 4;  // V1's W row stride: 68 floats

// V1's tile; its dynamic shared memory: two stages, WBUF decoded tiles,
// the rows' four values and the running sums.
template <int KC_, int TM_, int R_, int C_, int TPS_, int WBUF_, int U_>
struct StackedShape : Shape<KC_, TM_, R_, C_, TPS_> {
  static constexpr int WBUF = WBUF_, U = U_;
  static_assert(WBUF == 1 || WBUF == 2, "one or two decoded tiles");
  static_assert(U == 1 || U == 2 || U == 4, "U divides the 4 planes");
  static constexpr int SMEM = 2 * sizeof(Stage<TM_, KC_>)
      + WBUF * TM_ * WSTRIDE * 4 + TM_ * 16
      + Shape<KC_, TM_, R_, C_, TPS_>::SUMS;
};

// V4's tile: B1's loop at R, C, TPS and SREG.
template <int KC>
struct NocompTile;
template <>
struct NocompTile<8> : b1::LoopShape<8, CROSSPROD_NOCOMP_TILE_8> {};
template <>
struct NocompTile<16> : b1::LoopShape<16, CROSSPROD_NOCOMP_TILE_16> {};
template <>
struct NocompTile<24> : b1::LoopShape<24, CROSSPROD_NOCOMP_TILE_24> {};
template <>
struct NocompTile<32> : b1::LoopShape<32, CROSSPROD_NOCOMP_TILE_32> {};

template <int KC>
struct StackedTile;
template <>
struct StackedTile<8> : StackedShape<8, CROSSPROD_STACKED_TILE_8> {};
template <>
struct StackedTile<16> : StackedShape<16, CROSSPROD_STACKED_TILE_16> {};
template <>
struct StackedTile<24> : StackedShape<24, CROSSPROD_STACKED_TILE_24> {};
template <>
struct StackedTile<32> : StackedShape<32, CROSSPROD_STACKED_TILE_32> {};

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// ---- V2 and V4: B1's kernel with one thing changed --------------------------

// V4: B1 without the compensation.
template <int KC>
__global__ void __launch_bounds__(NocompTile<KC>::NT,
                                  NocompTile<KC>::MIN_BLOCKS)
nocomp_tile_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ cf0,
                   const float* __restrict__ cf1,
                   const float* __restrict__ cf2,
                   const float* __restrict__ x, float* __restrict__ z,
                   long long p, long long nb, bool bytes16, bool x16) {
  b1::body<KC, NocompTile<KC>, false, false>(packed, cf0, cf1, cf2, x, z, p,
                                            nb, bytes16, x16);
}

// V2: B1 with the integer (t - 1) shift; cf0..cf2 hold g0..g2.
template <int KC>
__global__ void __launch_bounds__(b1::Tile<KC>::NT,
                                  b1::Tile<KC>::MIN_BLOCKS)
intsub_tile_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ g0,
                   const float* __restrict__ g1,
                   const float* __restrict__ g2,
                   const float* __restrict__ x, float* __restrict__ z,
                   long long p, long long nb, bool bytes16, bool x16) {
  b1::body<KC, b1::Tile<KC>, true, true>(packed, g0, g1, g2, x, z, p, nb,
                                         bytes16, x16);
}

// ---- V1: decode once a block, then one contraction over the stacked
// planes ---------------------------------------------------------------------

// Decode half ``h`` (bytes [16h, 16h + 16)) of the staged chunk's TM rows
// into ``w``: row r, stacked sample s * 16 + j.  NT threads share the
// TM x 4 units (row, plane); consecutive threads take consecutive rows.
template <int KC, int TM, int NT>
__device__ __forceinline__ void decode_half(const Stage<TM, KC>& cur, int h,
                                            float* __restrict__ w,
                                            const float4* __restrict__ stab,
                                            int tid) {
  for (int u = tid; u < 4 * TM; u += NT) {
    const int r = u % TM;
    const int s = u / TM;
    const uint4 words =
        *reinterpret_cast<const uint4*>(&cur.bytes[r][HB * h]);
    const float4 t4 = stab[r];
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
    const uint32_t wd[4] = {words.x >> (2 * s), words.y >> (2 * s),
                            words.z >> (2 * s), words.w >> (2 * s)};
    float4* dst = reinterpret_cast<float4*>(w + r * WSTRIDE + HB * s);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(fp::pick(wd[q], 0, t), fp::pick(wd[q], 8, t),
                           fp::pick(wd[q], 16, t), fp::pick(wd[q], 24, t));
  }
}

// acc[i][c] += w(row_i, s * 16 + j) x[s][16h + j][cg * C + c] over the 64
// stacked samples of half ``h``, in their order; U planes unrolled.
template <int KC, int TM, int R, int C, int SLOTS, int U>
__device__ __forceinline__ void contract_half(const Stage<TM, KC>& cur,
                                              int h,
                                              const float* __restrict__ w,
                                              float (&acc)[R][C], int slot,
                                              int cg) {
#pragma unroll (U)
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int j4 = 0; j4 < HB / 4; ++j4) {
      float4 wv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        wv[i] = *reinterpret_cast<const float4*>(
            w + (slot + i * SLOTS) * WSTRIDE + HB * s + 4 * j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* xr = reinterpret_cast<const float4*>(
            &cur.x[s][HB * h + 4 * j4 + jj][cg * C]);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 xv = xr[q];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float wi = lane(wv[i], jj);
            acc[i][4 * q + 0] = fmaf(wi, xv.x, acc[i][4 * q + 0]);
            acc[i][4 * q + 1] = fmaf(wi, xv.y, acc[i][4 * q + 1]);
            acc[i][4 * q + 2] = fmaf(wi, xv.z, acc[i][4 * q + 2]);
            acc[i][4 * q + 3] = fmaf(wi, xv.w, acc[i][4 * q + 3]);
          }
        }
      }
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(StackedTile<KC>::NT,
                                  StackedTile<KC>::MIN_BLOCKS)
stacked_tile_kernel(const uint8_t* __restrict__ packed,
                    const float* __restrict__ cf0,
                    const float* __restrict__ cf1,
                    const float* __restrict__ cf2,
                    const float* __restrict__ x, float* __restrict__ z,
                    long long p, long long nb, bool bytes16, bool x16) {
  using T = StackedTile<KC>;
  constexpr int TM = T::TM, R = T::R, C = T::C, NT = T::NT;
  constexpr int WBUF = T::WBUF;
  constexpr int SLOTS = TM / R;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<TM, KC>* sg = reinterpret_cast<Stage<TM, KC>*>(smem);
  float* wt = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<TM, KC>));
  float4* stab = reinterpret_cast<float4*>(wt + WBUF * TM * WSTRIDE);
  // sum[i][c] of thread tid at ssum[(i * C + c) * NT + tid]
  float* ssum = reinterpret_cast<float*>(stab + TM);

  const int tid = threadIdx.x;
  const int slot = tid % SLOTS;
  const int cg = tid / SLOTS;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;

  // each row's four values, read by the decode (visible after the first
  // barrier of the chunk loop)
  for (int r = tid; r < TM; r += NT) {
    float t[4];
    row_values(row0 + r, p, cf0, cf1, cf2, t);
    stab[r] = make_float4(t[0], t[1], t[2], t[3]);
  }

  float err[R][C], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ssum[(i * C + c) * NT + tid] = 0.0f;
      err[i][c] = 0.0f;
      acc[i][c] = 0.0f;
    }
  }

  const long long nchunk = (nb + CB - 1) / CB;
  fp::stage_chunk<TM, BSTRIDE, KC, NT>(sg[0], packed, x, p, nb, row0, 0,
                                       bytes16, x16, tid);
  fp::cp_async_commit();
  for (long long ch = 0; ch < nchunk; ++ch) {
    // chunk ch has landed for every thread, and every thread is done
    // with chunk ch - 1: its stage, which the next copies overwrite, and
    // the decoded tiles
    fp::cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < nchunk)
      fp::stage_chunk<TM, BSTRIDE, KC, NT>(sg[(ch + 1) & 1], packed, x, p,
                                           nb, row0, (ch + 1) * CB, bytes16,
                                           x16, tid);
    fp::cp_async_commit();

    const Stage<TM, KC>& cur = sg[ch & 1];
    // the first design's 16-byte chunks: the second half exists only
    // where it holds a byte below nb (uniform across the block)
    const int halves = ch * CB + HB < nb ? 2 : 1;
    if constexpr (WBUF == 2) {
      for (int h = 0; h < halves; ++h)
        decode_half<KC, TM, NT>(cur, h, wt + h * TM * WSTRIDE, stab, tid);
      __syncthreads();
    }
#pragma unroll 1
    for (int h = 0; h < halves; ++h) {
      const float* w = wt + (WBUF == 2 ? h : 0) * TM * WSTRIDE;
      if constexpr (WBUF == 1) {
        if (h) __syncthreads();  // every thread is done with half 0's tile
        decode_half<KC, TM, NT>(cur, h, wt, stab, tid);
        __syncthreads();
      }
      contract_half<KC, TM, R, C, SLOTS, T::U>(cur, h, w, acc, slot, cg);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (i * C + c) * NT + tid;
          float t, e;
          fp::two_sum(ssum[o], acc[i][c], t, e);
          ssum[o] = t;
          err[i][c] = __fadd_rn(err[i][c], e);
          acc[i][c] = 0.0f;
        }
      }
    }
  }

  write_out<KC, R, C, SLOTS>(
      z, p, row0, slot, cg,
      [&](int i, int c) { return ssum[(i * C + c) * NT + tid]; },
      [&](float s, int i, int c) { return __fadd_rn(s, err[i][c]); });
}

// ---- launch ----------------------------------------------------------------

struct Args {
  const uint8_t* pk;
  const float *c0, *c1, *c2, *x;
  float* z;
  long long p, nb;
  bool bytes16, x16;
};

template <typename Kernel>
int start(Kernel kernel, int tm, int nt, int smem, const Args& a,
          cudaStream_t st) {
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((a.p + tm - 1) / tm));
  kernel<<<grid, nt, smem, st>>>(a.pk, a.c0, a.c1, a.c2, a.x, a.z, a.p,
                                 a.nb, a.bytes16, a.x16);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int start_nocomp(const Args& a, cudaStream_t st) {
  using T = NocompTile<KC>;
  return start(nocomp_tile_kernel<KC>, T::TM, T::NT, T::SMEM, a, st);
}

template <int KC>
int start_stacked(const Args& a, cudaStream_t st) {
  using T = StackedTile<KC>;
  return start(stacked_tile_kernel<KC>, T::TM, T::NT, T::SMEM, a, st);
}

template <int KC>
int start_intsub(const Args& a, cudaStream_t st) {
  using T = b1::Tile<KC>;
  return start(intsub_tile_kernel<KC>, T::TM, T::NT, T::SMEM, a, st);
}

enum Variant { kStacked, kIntsub, kNocomp };

template <int KC>
int start_variant(Variant v, const Args& a, cudaStream_t st) {
  switch (v) {
    case kStacked: return start_stacked<KC>(a, st);
    case kIntsub: return start_intsub<KC>(a, st);
    default: return start_nocomp<KC>(a, st);
  }
}

// Check the operands and launch V1, V2 or V4 at KC = kc.
int launch(Variant v, const void* packed, const void* cf0,
           const void* cf1, const void* cf2, const void* x, void* z,
           long long p, long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{static_cast<const uint8_t*>(packed),
               static_cast<const float*>(cf0),
               static_cast<const float*>(cf1),
               static_cast<const float*>(cf2),
               static_cast<const float*>(x),
               static_cast<float*>(z),
               p,
               nb,
               nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0,
               reinterpret_cast<uintptr_t>(x) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return start_variant<8>(v, a, st);
    case 16: return start_variant<16>(v, a, st);
    case 24: return start_variant<24>(v, a, st);
    case 32: return start_variant<32>(v, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace var2

}  // namespace

// All three take B1's arguments: packed (p, nb) u8; cf0..cf2 (p,) f32
// (the g-coefficients for V2); x (4*nb, kc) f32; z (p, kc) f32.
extern "C" int fp_crossprod_stacked(const void* packed, const void* cf0,
                                    const void* cf1, const void* cf2,
                                    const void* x, void* z, long long p,
                                    long long nb, int kc, void* stream) {
  return var2::launch(var2::kStacked, packed, cf0, cf1, cf2, x, z, p, nb, kc,
                      stream);
}

extern "C" int fp_crossprod_intsub(const void* packed, const void* cf0,
                                   const void* cf1, const void* cf2,
                                   const void* x, void* z, long long p,
                                   long long nb, int kc, void* stream) {
  return var2::launch(var2::kIntsub, packed, cf0, cf1, cf2, x, z, p, nb, kc,
                      stream);
}

extern "C" int fp_crossprod_nocomp(const void* packed, const void* cf0,
                                   const void* cf1, const void* cf2,
                                   const void* x, void* z, long long p,
                                   long long nb, int kc, void* stream) {
  return var2::launch(var2::kNocomp, packed, cf0, cf1, cf2, x, z, p, nb, kc,
                      stream);
}
