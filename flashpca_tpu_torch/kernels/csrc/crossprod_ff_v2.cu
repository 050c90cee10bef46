// B3: the two-float (z_hi, z_err) of z = W x, where W = W_hi + W_lo is
// the exact float64 standardized matrix split into a float32 pair, each
// decoded by an exact per-code select from the six per-SNP table values
// (hi and lo for codes 0, 2, 3; code 1, missing, is exactly +0).
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_crossprod_ff_kernel.
// crossprod_ff.cu keeps the first Hopper design of this function as
// fp_crossprod_ff_v1, for comparison.
//
// Bound: float32 FMAs on the CUDA cores -- two products per genotype
// and column (x W_hi and x W_lo), 4*KC*p*n4 operations (the 12.6 GB of
// packed bytes take a tenth of that time at the memory rate).  No TF32,
// bf16 split or tensor cores: the check contract needs full float32
// products, and the eps-sized lo table must reach them bit for bit.
//
// The sums are bit for bit the first design's.  For each output z[row, c]
// both compute acc = fmaf(x[s][j][c], w_hi, acc) and accl = fmaf(x[s][j][c],
// w_lo, accl) over the bytes j of a 32-byte chunk in order and, within a
// byte, the planes s = 0..3; at the chunk's end two_sum(sum, acc) -> (sum,
// e) and err = (err + e) + accl, each add rounded on its own; sum and err
// are the outputs.  The decoded values are table entries, moved and never
// computed, and ragged edges take the same padding (byte 0x55, zero x
// rows) through the same operations.  Only the mapping of outputs to
// threads and the staging differ.
//
// Design (the first design is B1's first design with a second product:
// one thread owned a row and all KC columns, 4*KC floats of state, 196
// blocks of 256 rows on the tall shape for 132 SMs, and plain staging
// with two barriers per chunk):
// * Thread tile: R SNP rows x C columns; acc and accl in registers
//   (2*R*C floats), the running sum and err in shared memory (read and
//   written once per chunk by the fold, thread-fastest).  A block is TM
//   = 128 rows: 128 / R row slots x KC / C column groups.  The 32 lanes
//   of a warp take 32 consecutive row slots of one column group, so each
//   broadcast float4 of x feeds 2*R*4 FFMAs.  One x value feeds two
//   products here (B1: one), so B3 needs no second row to amortise its x
//   loads: R = 1 keeps the per-row decode and byte words of one row only.
// * Decode from registers: each row's six table values become two
//   4-entry tables, {h0, +0, h2, h3} and {g0, +0, g2, g3}, both indexed by
//   the code through the same two bit tests (fp::pick; the compiler
//   shares the tests), with no arithmetic on the values.  Per sample and
//   thread: 2*R*C FFMA, C/4 LDS.128 of x, 8*R decode instructions.
// * Grid and occupancy: grid p / 128 (392 blocks at p = 50,176, 784 at
//   100,352).  __launch_bounds__ asks for TPS threads an SM:
//     KC  R   C  threads  TPS  reg. cap  smem KB  blocks/SM  tall  wide
//      8  1   8    128    768     80       24         6      0.49  0.99
//     16  1   8    256    768     80       40         3      0.99  1.98
//     24  1  12    256    768     80       56         3      0.99  1.98
//     32  1  16    256    512    128       72         2      1.48  2.97
//   (blocks/SM by threads, registers and shared memory, 228 KB an SM
//   less 1 KB a block; the last two columns are waves, blocks / (132 SMs
//   x blocks/SM), on the tall and wide shapes.)  Threads a launch: p *
//   KC / (R * C), since bit-identity forbids split-K: at R*C = 16 the
//   tall kc=32 launch has 3,136 warps, 24 an SM in one wave -- but only
//   at 80 registers, where C = 16 ran 15% slower on the card than at
//   128 registers and 16 warps an SM, whose last wave is half full.
// * Staging: double-buffered with cp.async one 32-byte chunk at a time
//   (fp::stage_chunk, as B1): the copies of chunk i+1 (the 128 x 32-byte
//   tile and the 4 x 32 x KC x-tile) are in flight while chunk i is
//   computed, with one barrier per chunk.  The byte tile is unpadded (32
//   bytes a row) to fit three blocks an SM at KC = 32: a thread reads its
//   row's 16 bytes once per 64 samples, so the two-way bank conflict of
//   that read costs nothing measurable.  Ragged edges keep the first
//   design's rule; rows whose bytes are not 16-byte aligned (nb % 16 !=
//   0) are staged byte by byte.
//
// A source that defines CROSSPROD_FF_TILE_<KC> as "R, C, TPS" and then
// includes this one builds B3 at another tile: tools/b3_tiles.py times
// other tiles that way.  The tiles tried on the card are in PERF.md.
#include "common.cuh"

#ifndef CROSSPROD_FF_TILE_8
#define CROSSPROD_FF_TILE_8 1, 8, 768
#endif
#ifndef CROSSPROD_FF_TILE_16
#define CROSSPROD_FF_TILE_16 1, 8, 768
#endif
#ifndef CROSSPROD_FF_TILE_24
#define CROSSPROD_FF_TILE_24 1, 12, 768
#endif
#ifndef CROSSPROD_FF_TILE_32
#define CROSSPROD_FF_TILE_32 1, 16, 512
#endif

namespace {

namespace ff2 {

constexpr int CB = fp::kChunkBytes;  // bytes a chunk (128 samples): one fold
constexpr int BSTRIDE = CB;          // byte-tile row stride: unpadded
constexpr int TM = 128;              // SNP rows a block

template <int KC>
using Stage = fp::ChunkStage<TM, BSTRIDE, KC>;

// A tile: R rows and C columns a thread, TPS threads an SM; threads per
// block (TM / R row slots x KC / C column groups) and the dynamic shared
// memory: two stages, then the running sums and errors, TM x KC each.
template <int KC_, int R_, int C_, int TPS_>
struct Shape {
  static constexpr int KC = KC_, R = R_, C = C_, TPS = TPS_;
  static_assert(KC % C == 0 && C % 4 == 0, "C must divide KC, 4 | C");
  static_assert(TM % (32 * R) == 0, "a warp takes 32 row slots");
  static constexpr int NT = TM / R * (KC / C);
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int SMEM = 2 * sizeof(Stage<KC>) + 2 * TM * KC * 4;
};

template <int KC>
struct Tile;
template <>
struct Tile<8> : Shape<8, CROSSPROD_FF_TILE_8> {};
template <>
struct Tile<16> : Shape<16, CROSSPROD_FF_TILE_16> {};
template <>
struct Tile<24> : Shape<24, CROSSPROD_FF_TILE_24> {};
template <>
struct Tile<32> : Shape<32, CROSSPROD_FF_TILE_32> {};

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
crossprod_ff_tile_kernel(const uint8_t* __restrict__ packed,
                         const float* __restrict__ lut6,
                         const float* __restrict__ x, float* __restrict__ zh,
                         float* __restrict__ zl, long long p, long long nb,
                         bool bytes16, bool x16) {
  constexpr int R = Tile<KC>::R;
  constexpr int C = Tile<KC>::C;
  constexpr int NT = Tile<KC>::NT;
  constexpr int SLOTS = TM / R;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<KC>* sg = reinterpret_cast<Stage<KC>*>(smem);
  // sum and err of output (i, c) of thread tid at [(i * C + c) * NT +
  // tid]: read and written once per chunk, by the fold
  float* ssum = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<KC>));
  float* serr = ssum + TM * KC;

  const int tid = threadIdx.x;
  // rows slot + i * SLOTS (i < R): 32 lanes take 32 consecutive rows
  const int slot = tid % SLOTS;
  const int cg = tid / SLOTS;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;

  // each row's hi and lo values by code, {h0, +0, h2, h3} and {g0, +0,
  // g2, g3} (lut6 rows h0, h2, h3, g0, g2, g3, each (p,))
  float th[R][4], tl[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long gr = row0 + slot + i * SLOTS;
    const bool live = gr < p;
    th[i][0] = live ? lut6[0 * p + gr] : 0.0f;
    th[i][1] = 0.0f;
    th[i][2] = live ? lut6[1 * p + gr] : 0.0f;
    th[i][3] = live ? lut6[2 * p + gr] : 0.0f;
    tl[i][0] = live ? lut6[3 * p + gr] : 0.0f;
    tl[i][1] = 0.0f;
    tl[i][2] = live ? lut6[4 * p + gr] : 0.0f;
    tl[i][3] = live ? lut6[5 * p + gr] : 0.0f;
  }

  float acc[R][C], accl[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ssum[(i * C + c) * NT + tid] = 0.0f;
      serr[(i * C + c) * NT + tid] = 0.0f;
      acc[i][c] = 0.0f;
      accl[i][c] = 0.0f;
    }
  }

  const long long nchunk = (nb + CB - 1) / CB;
  fp::stage_chunk<TM, BSTRIDE, KC, NT>(sg[0], packed, x, p, nb, row0, 0,
                                       bytes16, x16, tid);
  fp::cp_async_commit();
  for (long long ch = 0; ch < nchunk; ++ch) {
    // chunk ch has landed for every thread, and every thread is done
    // with chunk ch - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < nchunk)
      fp::stage_chunk<TM, BSTRIDE, KC, NT>(sg[(ch + 1) & 1], packed, x, p,
                                           nb, row0, (ch + 1) * CB, bytes16,
                                           x16, tid);
    fp::cp_async_commit();

    const Stage<KC>& cur = sg[ch & 1];
#pragma unroll 1
    for (int h = 0; h < CB / 16; ++h) {
      uint32_t wd[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const uint4 words = *reinterpret_cast<const uint4*>(
            &cur.bytes[slot + i * SLOTS][16 * h]);
        wd[i][0] = words.x;
        wd[i][1] = words.y;
        wd[i][2] = words.z;
        wd[i][3] = words.w;
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * h + jj;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float wh[R], wl[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int sh = 8 * (jj % 4) + 2 * s;
            wh[i] = fp::pick(wd[i][jj / 4], sh, th[i]);
            wl[i] = fp::pick(wd[i][jj / 4], sh, tl[i]);
          }
          const float4* xr =
              reinterpret_cast<const float4*>(&cur.x[s][j][cg * C]);
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 xv = xr[q];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][4 * q + 0] = fmaf(xv.x, wh[i], acc[i][4 * q + 0]);
              acc[i][4 * q + 1] = fmaf(xv.y, wh[i], acc[i][4 * q + 1]);
              acc[i][4 * q + 2] = fmaf(xv.z, wh[i], acc[i][4 * q + 2]);
              acc[i][4 * q + 3] = fmaf(xv.w, wh[i], acc[i][4 * q + 3]);
              accl[i][4 * q + 0] = fmaf(xv.x, wl[i], accl[i][4 * q + 0]);
              accl[i][4 * q + 1] = fmaf(xv.y, wl[i], accl[i][4 * q + 1]);
              accl[i][4 * q + 2] = fmaf(xv.z, wl[i], accl[i][4 * q + 2]);
              accl[i][4 * q + 3] = fmaf(xv.w, wl[i], accl[i][4 * q + 3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (i * C + c) * NT + tid;
        float t, e;
        fp::two_sum(ssum[o], acc[i][c], t, e);
        ssum[o] = t;
        serr[o] = __fadd_rn(__fadd_rn(serr[o], e), accl[i][c]);
        acc[i][c] = 0.0f;
        accl[i][c] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = row0 + slot + i * SLOTS;
    if (row < p) {
      float4* oh = reinterpret_cast<float4*>(zh + row * KC + cg * C);
      float4* ol = reinterpret_cast<float4*>(zl + row * KC + cg * C);
      const float* sum = &ssum[i * C * NT + tid];
      const float* err = &serr[i * C * NT + tid];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        oh[q] = make_float4(sum[(4 * q + 0) * NT], sum[(4 * q + 1) * NT],
                            sum[(4 * q + 2) * NT], sum[(4 * q + 3) * NT]);
        ol[q] = make_float4(err[(4 * q + 0) * NT], err[(4 * q + 1) * NT],
                            err[(4 * q + 2) * NT], err[(4 * q + 3) * NT]);
      }
    }
  }
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* lt, const float* xx,
              float* oh, float* ol, long long p, long long nb, bool bytes16,
              bool x16, cudaStream_t st) {
  using T = Tile<KC>;
  cudaError_t rc = cudaFuncSetAttribute(
      crossprod_ff_tile_kernel<KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(crossprod_ff_tile_kernel<KC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((p + TM - 1) / TM));
  crossprod_ff_tile_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, lt, xx, oh, ol, p, nb, bytes16, x16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ff2

}  // namespace

// B3. packed (p, nb) u8; lut6 (6, p) f32; x (4*nb, kc) f32; zh, zl (p,
// kc) f32.
extern "C" int fp_crossprod_ff(const void* packed, const void* lut6,
                               const void* x, void* zh, void* zl, long long p,
                               long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* lt = static_cast<const float*>(lut6);
  const auto* xx = static_cast<const float*>(x);
  auto* oh = static_cast<float*>(zh);
  auto* ol = static_cast<float*>(zl);
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(zh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(zl) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return ff2::launch_kc<8>(pk, lt, xx, oh, ol, p, nb, bytes16, x16, st);
    case 16: return ff2::launch_kc<16>(pk, lt, xx, oh, ol, p, nb, bytes16, x16, st);
    case 24: return ff2::launch_kc<24>(pk, lt, xx, oh, ol, p, nb, bytes16, x16, st);
    case 32: return ff2::launch_kc<32>(pk, lt, xx, oh, ol, p, nb, bytes16, x16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
