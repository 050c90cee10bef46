// V3 ("split3") redesigned for Hopper: B1's z = W x with every product
// taken on the tensor cores as three bf16 products with float32
// accumulation, wh xh + wh xl + wl xh (the lo * lo term dropped), for the
// kernel sweep (tools/kernel_sweep.py).
//
// Replaces .claude/skills/verify/kernel_sweep.py::_crossprod_kernel_split3
// (its _split_bf16 and _dot3).  crossprod_split3.cu keeps the first design
// as fp_crossprod_split3_v1, for comparison.
//
// Bound: the largest of three terms.  The three bf16 products need
// 6*KC*p*n4 operations at 989 TFLOP/s (4.9 ms at KC = 16 on the wide
// headline) and the packed bytes 3.8 ms.  The CUDA-core work that the
// function needs, at one instruction per lane and clock, is the pick (a
// byte permute for each of the hi and lo words of two genotypes: 1 a
// genotype) and the TwoSum fold every 32 bytes (7 adds a column: 7 KC /
// 128 a genotype), 1.875 a genotype or 2.8 ms at KC = 16.  So the tensor
// products bound it.  chip_smoke.py prints beside the bound the
// CUDA-core instructions that this kernel's loop issues per genotype,
// read from its SASS; the first design spent 9 a genotype on the decode
// and the split alone.
//
// The sums are bit for bit the first design's.  Both issue
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) with the same fragment
// assignment: M = 16 SNP rows (a row at position row % 16 of its tile), N
// = 8 panel columns, K = 16 consecutive bytes j0..j0+15 of one plane s of
// a 32-byte fold unit.  Each output's accumulator takes, per fold unit,
// j0 = 0 then 16, the planes s = 0..3, and within those wh xh, wh xl, wl
// xh; at the unit's end two_sum(sum, acc) and err += e; sum + err at the
// end.  The A values are the first design's bits: decode_cubic_rn of the
// code split by split_bf16x2; so are the B values: split_bf16 of x, 0 past
// byte nb; and ragged rows read byte 0x55 past row p or byte nb.
//
// Design (the first design decoded and split every genotype of its A
// fragments on the CUDA cores, 9 instructions each, split the whole panel
// again in every block, staged one byte a thread with two barriers every
// 32 bytes, and fed 3 * KC / 8 products from each B fragment):
// * Per-row table: each thread computes decode_cubic_rn(t) for t = 0..3
//   of its rows once a kernel and splits them, 4 hi and 4 lo bf16 values
//   in two 32-bit registers each.  For two samples of a row the codes c,
//   c' give one selector, ((bytes >> 2s) & 0x03030303) * 34 + 0x10101010
//   (nibbles 2c, 2c + 1, 2c', 2c' + 1; its upper half serves the pair 8
//   samples on), and two byte permutes (PRMT) pick the A fragment's hi and
//   lo words from the table: the same bits as decoding and splitting, and
//   missing (code 1) its exact zero.
// * The panel split once a launch: a pre-pass kernel (split_panel_kernel)
//   writes x's bf16 hi and lo planes to a scratch tensor that the wrapper
//   allocates, per 32-byte chunk [hi/lo][plane][column][32 samples], the
//   first design's shared-memory order (xh[s][c][j]); the pre-pass is
//   part of the entry, so a timed launch covers it.
// * cp.async staging of 16-byte pieces, double buffered, of SB packed
//   bytes of the block's rows and the pre-split panel of their SB / 32
//   fold units: one barrier per stage, the fold still at every 32 bytes;
//   a thread copies the same pieces of every stage, from pointers set
//   once.
//   Rows whose bytes are not 16-byte aligned (nb % 16 != 0) are staged
//   byte by byte (the kernel's B16 = false instantiation); fold units past
//   the last chunk are neither staged nor folded (the first design has
//   none).
// * More output per B fragment: a warp owns MT 16-row M tiles, so each B
//   fragment, read with one ldmatrix.x4 (hi and lo, both k halves; panel
//   rows 80 bytes apart, so its 8-row phases are conflict-free), feeds 3 *
//   MT products.  Block: NW warps, TM = 16 * MT * NW rows.
//
// A source that defines CROSSPROD_SPLIT3_TILE_<KC> as "MT, NW, SB, TPS"
// (TPS: the threads an SM that __launch_bounds__ asks for) and then
// includes this one builds V3 at another tile: tools/variant_tiles.py
// times other tiles that way.  At KC = 16, the sweep's width, the
// production tile had the lowest mean of the tiles tried over six turns,
// but the three next to it came within 3% of it, less than the spread
// between turns of one tile, so which tile is fastest is not resolved.
// Production is the steadiest of the four.  The other KCs take the same
// shape, with TPS as shared memory allows, untimed.  The tiles tried and
// their times are in PERF.md.
#include "common.cuh"

#ifndef CROSSPROD_SPLIT3_TILE_8
#define CROSSPROD_SPLIT3_TILE_8 2, 4, 64, 512
#endif
#ifndef CROSSPROD_SPLIT3_TILE_16
#define CROSSPROD_SPLIT3_TILE_16 2, 4, 64, 384
#endif
#ifndef CROSSPROD_SPLIT3_TILE_24
#define CROSSPROD_SPLIT3_TILE_24 2, 4, 64, 256
#endif
#ifndef CROSSPROD_SPLIT3_TILE_32
#define CROSSPROD_SPLIT3_TILE_32 2, 4, 64, 256
#endif

namespace {

namespace s3 {

constexpr int CB = fp::kChunkBytes;  // bytes a fold unit (the first design's chunk)
constexpr int XROW = CB + 8;         // bf16 a panel row in shared memory: 80 bytes
constexpr int PNT = 256;             // threads a pre-pass block

// A tile: MT M tiles a warp, NW warps a block, SB bytes a stage, TPS
// threads an SM; its rows and threads a block, and its dynamic shared
// memory: two stages, each the byte tile (TM rows PS bytes apart) and
// the panel rows [unit][hi/lo][plane][column] of its fold units.
template <int KC_, int MT_, int NW_, int SB_, int TPS_>
struct Shape {
  static constexpr int KC = KC_, MT = MT_, NW = NW_, SB = SB_, TPS = TPS_;
  static_assert(KC % 8 == 0, "n-tiles of 8 columns");
  static_assert(SB % CB == 0, "a stage holds whole fold units");
  static constexpr int TM = 16 * MT * NW;
  static constexpr int NT = 32 * NW;
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int NTILES = KC / 8;
  static constexpr int UNITS = SB / CB;
  static constexpr int PS = SB + 16;
  static constexpr int PROWS = UNITS * 8 * KC;
  static constexpr int BYTES = TM * PS;
  static constexpr int STAGE = BYTES + PROWS * XROW * 2;
  static constexpr int SMEM = 2 * STAGE;
};

template <int KC>
struct Split3Tile;
template <>
struct Split3Tile<8> : Shape<8, CROSSPROD_SPLIT3_TILE_8> {};
template <>
struct Split3Tile<16> : Shape<16, CROSSPROD_SPLIT3_TILE_16> {};
template <>
struct Split3Tile<24> : Shape<24, CROSSPROD_SPLIT3_TILE_24> {};
template <>
struct Split3Tile<32> : Shape<32, CROSSPROD_SPLIT3_TILE_32> {};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, lane L giving row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fp::smem_addr(p)));
}

// Row ``gr``'s table (0 past row p): the bf16 hi and lo halves of its
// four values decode_cubic_rn(t), t = 0..3, as split_bf16x2 packs them
// (h[0] = hi(0) | hi(1) << 16, h[1] = hi(2) | hi(3) << 16; l likewise).
__device__ __forceinline__ void row_table(long long gr, long long p,
                                          const float* __restrict__ cf0,
                                          const float* __restrict__ cf1,
                                          const float* __restrict__ cf2,
                                          uint32_t (&h)[2], uint32_t (&l)[2]) {
  const bool live = gr < p;
  const float b0 = live ? cf0[gr] : 0.0f;
  const float b1 = live ? cf1[gr] : 0.0f;
  const float b2 = live ? cf2[gr] : 0.0f;
  fp::split_bf16x2(fp::decode_cubic_rn(0u, b0, b1, b2),
                   fp::decode_cubic_rn(1u, b0, b1, b2), h[0], l[0]);
  fp::split_bf16x2(fp::decode_cubic_rn(2u, b0, b1, b2),
                   fp::decode_cubic_rn(3u, b0, b1, b2), h[1], l[1]);
}

// The pre-pass: chunk blockIdx.x of x (4 planes x 32 samples x KC
// columns, 0 past byte nb) split into bf16 hi and lo, written to xs as
// [hi/lo][plane][column][32 samples] (sample pairs one 32-bit word, the
// earlier sample in the low half).
template <int KC>
__global__ void __launch_bounds__(PNT)
split_panel_kernel(const float* __restrict__ x, uint32_t* __restrict__ xs,
                   long long nb) {
  __shared__ float tile[4][CB][KC + 1];
  const long long base = static_cast<long long>(blockIdx.x) * CB;
  for (int idx = threadIdx.x; idx < 4 * CB * KC; idx += PNT) {
    const int s = idx / (CB * KC);
    const int rem = idx % (CB * KC);
    const int j = rem / KC;
    const int c = rem % KC;
    const long long gb = base + j;
    tile[s][j][c] =
        gb < nb ? x[(static_cast<long long>(s) * nb + gb) * KC + c] : 0.0f;
  }
  __syncthreads();
  constexpr int HALF = CB / 2;
  uint32_t* out = xs + static_cast<long long>(blockIdx.x) * 8 * KC * HALF;
  for (int idx = threadIdx.x; idx < 4 * KC * HALF; idx += PNT) {
    const int s = idx / (KC * HALF);
    const int rem = idx % (KC * HALF);
    const int c = rem / HALF;
    const int jp = rem % HALF;
    uint32_t hi, lo;
    fp::split_bf16x2(tile[s][2 * jp][c], tile[s][2 * jp + 1][c], hi, lo);
    out[(s * KC + c) * HALF + jp] = hi;
    out[((4 + s) * KC + c) * HALF + jp] = lo;
  }
}

// prmt.b32: the bytes of {b, a} that the selector's four low nibbles
// pick (each below 8 here, so no sign replication; __byte_perm would mask
// the selector first).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// Start the copies of stage ``st`` into ``sg``: bytes [st * SB, st * SB
// + SB) of rows [row0, row0 + TM) and the panel rows of fold units
// [st * UNITS, ...) below nchunk.  A thread's pieces are fixed across
// stages: byte pieces tid % Q of rows brow + k * NT / Q (from ``bsrc``,
// rows ``bstride`` bytes apart), panel pieces tid % 4 of panel rows
// tid / 4 + k * NT / 4 (from ``psrc``).  Byte 0x55 past row p or byte
// nb, by plain stores; with B16 every row's bytes are 16-byte aligned.
template <typename T, bool B16>
__device__ __forceinline__ void stage(unsigned char* sg,
                                      const uint8_t* __restrict__ bsrc,
                                      long long bstride, long long brow,
                                      const uint16_t* __restrict__ psrc,
                                      long long p, long long nb,
                                      long long nchunk, long long st,
                                      int tid) {
  constexpr int NT = T::NT, KC = T::KC;
  constexpr int Q = T::SB / 16;     // 16-byte pieces a row
  constexpr int RS = NT / Q;        // rows between a thread's pieces
  constexpr int PR = NT / 4;        // panel rows between a thread's pieces
  static_assert(NT % Q == 0, "a block's threads cover whole rows");
  const long long gb = st * T::SB + 16 * (tid % Q);
  unsigned char* bdst = sg + (tid / Q) * T::PS + 16 * (tid % Q);
  const uint8_t* src = bsrc + st * T::SB;
#pragma unroll
  for (int k = 0; k < T::TM / RS; ++k) {
    unsigned char* dst = bdst + k * RS * T::PS;
    const bool row = brow + k * RS < p;
    if (B16) {
      if (row && gb + 16 <= nb)
        fp::cp_async16(dst, src + k * bstride);
      else
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(0x55555555u, 0x55555555u, 0x55555555u, 0x55555555u);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (row && gb + e < nb) ? src[k * bstride + e]
                                      : fp::kMissingByte;
    }
  }
  // the panel rows of the stage's fold units, 4 pieces a row
  const long long u0 = st * T::UNITS;
  const long long units = nchunk - u0 < T::UNITS ? nchunk - u0 : T::UNITS;
  const int live = static_cast<int>(units) * 8 * KC * 4;
  unsigned char* pdst =
      sg + T::BYTES + ((tid >> 2) * XROW + 8 * (tid & 3)) * 2;
  const uint16_t* ps = psrc + u0 * 8 * KC * CB;
#pragma unroll
  for (int k = 0; k < (T::PROWS * 4 + NT - 1) / NT; ++k)
    if (tid + k * NT < live)
      fp::cp_async16(pdst + k * PR * XROW * 2, ps + k * PR * CB);
}

template <int KC, bool B16>
__global__ void __launch_bounds__(Split3Tile<KC>::NT,
                                  Split3Tile<KC>::MIN_BLOCKS)
split_tile_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ cf0,
                   const float* __restrict__ cf1,
                   const float* __restrict__ cf2,
                   const uint16_t* __restrict__ xs, float* __restrict__ z,
                   long long p, long long nb) {
  using T = Split3Tile<KC>;
  constexpr int MT = T::MT, NTILES = T::NTILES, UNITS = T::UNITS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;          // fragment row group
  const int t = lane % 4;          // thread in group
  const int wrow = (tid / 32) * MT * 16;   // the warp's first row in the block
  const long long row0 = static_cast<long long>(blockIdx.x) * T::TM;

  // rows wrow + 16 mt + g + 8 h: h = 0 feeds A registers 0 and 2, h = 1
  // registers 1 and 3
  uint32_t th[MT][2][2], tl[MT][2][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_table(row0 + wrow + 16 * mt + g + 8 * h, p, cf0, cf1, cf2,
                th[mt][h], tl[mt][h]);

  float sum[MT][NTILES][4], err[MT][NTILES][4], acc[MT][NTILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum[mt][n][i] = 0.0f;
        err[mt][n][i] = 0.0f;
        acc[mt][n][i] = 0.0f;
      }

  // this lane's ldmatrix row: matrix lane / 8 is (hi, k 0..7), (hi, k
  // 8..15), (lo, k 0..7), (lo, k 8..15) of 8 panel columns
  const int lrow = ((lane >> 4) * 4 * KC + (lane & 7)) * XROW
                   + ((lane >> 3) & 1) * 8;

  // this thread's staging pieces (see stage)
  constexpr int Q = T::SB / 16;
  const long long brow = row0 + tid / Q;
  const uint8_t* bsrc = packed + brow * nb + 16 * (tid % Q);
  const long long bstride = static_cast<long long>(T::NT / Q) * nb;
  const uint16_t* psrc = xs + (tid >> 2) * CB + 8 * (tid & 3);

  const long long nchunk = (nb + CB - 1) / CB;
  const long long nstage = (nchunk + UNITS - 1) / UNITS;
  stage<T, B16>(smem, bsrc, bstride, brow, psrc, p, nb, nchunk, 0, tid);
  fp::cp_async_commit();
  for (long long st = 0; st < nstage; ++st) {
    // stage st has landed for every thread, and every thread is done
    // with stage st - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nstage)
      stage<T, B16>(smem + ((st + 1) & 1) * T::STAGE, bsrc, bstride, brow,
                    psrc, p, nb, nchunk, st + 1, tid);
    fp::cp_async_commit();

    const unsigned char* cur = smem + (st & 1) * T::STAGE;
    const uint16_t* panel = reinterpret_cast<const uint16_t*>(cur + T::BYTES);
    const long long left = nchunk - st * UNITS;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (u < left) {
#pragma unroll
        for (int j0 = 0; j0 < CB; j0 += 16) {
          // bytes j0 + 2t, + 1, + 8, + 9 of each row, in that order
          uint32_t wd[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned char* rb =
                  cur + (wrow + 16 * mt + g + 8 * h) * T::PS + u * CB + j0 + 2 * t;
              wd[mt][h] = static_cast<uint32_t>(
                              *reinterpret_cast<const uint16_t*>(rb))
                          | static_cast<uint32_t>(
                                *reinterpret_cast<const uint16_t*>(rb + 8))
                                << 16;
            }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            // A fragments (row-major 16 x 16): reg0 row g, k 2t..2t+1;
            // reg1 row g+8; reg2 row g, k 2t+8..2t+9; reg3 row g+8
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t sel =
                    ((wd[mt][h] >> (2 * s)) & 0x03030303u) * 34u + 0x10101010u;
                ah[mt][h] = prmt(th[mt][h][0], th[mt][h][1], sel);
                al[mt][h] = prmt(tl[mt][h][0], tl[mt][h][1], sel);
                ah[mt][2 + h] = prmt(th[mt][h][0], th[mt][h][1], sel >> 16);
                al[mt][2 + h] = prmt(tl[mt][h][0], tl[mt][h][1], sel >> 16);
              }
#pragma unroll
            for (int n = 0; n < NTILES; ++n) {
              // B fragments (column-major 16 x 8) of column n * 8 + g:
              // b[0], b[1] hi at k 2t.., 2t+8..; b[2], b[3] lo
              uint32_t b[4];
              ldmatrix_x4(b, panel + lrow
                                 + ((u * 8 * KC) + s * KC + n * 8) * XROW + j0);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][n], ah[mt], b[0], b[1]);   // wh xh
                mma_bf16(acc[mt][n], ah[mt], b[2], b[3]);   // wh xl
                mma_bf16(acc[mt][n], al[mt], b[0], b[1]);   // wl xh
              }
            }
          }
        }
        // the first design's fold, every 32 bytes
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NTILES; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float e;
              fp::two_sum(sum[mt][n][i], acc[mt][n][i], sum[mt][n][i], e);
              err[mt][n][i] = __fadd_rn(err[mt][n][i], e);
              acc[mt][n][i] = 0.0f;
            }
      }
    }
  }

  // C fragment: c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long long ra = row0 + wrow + 16 * mt + g;
    const long long rb = ra + 8;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const int col = n * 8 + 2 * t;
      if (ra < p)
        *reinterpret_cast<float2*>(z + ra * KC + col) =
            make_float2(__fadd_rn(sum[mt][n][0], err[mt][n][0]),
                        __fadd_rn(sum[mt][n][1], err[mt][n][1]));
      if (rb < p)
        *reinterpret_cast<float2*>(z + rb * KC + col) =
            make_float2(__fadd_rn(sum[mt][n][2], err[mt][n][2]),
                        __fadd_rn(sum[mt][n][3], err[mt][n][3]));
    }
  }
}

// ---- launch ----------------------------------------------------------------

struct Args {
  const uint8_t* pk;
  const float *c0, *c1, *c2, *x;
  uint16_t* xs;
  float* z;
  long long p, nb;
};

template <int KC, bool B16>
int start(const Args& a, cudaStream_t st) {
  using T = Split3Tile<KC>;
  const cudaError_t rc = cudaFuncSetAttribute(
      split_tile_kernel<KC, B16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((a.p + T::TM - 1) / T::TM));
  split_tile_kernel<KC, B16><<<grid, T::NT, T::SMEM, st>>>(
      a.pk, a.c0, a.c1, a.c2, a.xs, a.z, a.p, a.nb);
  return static_cast<int>(cudaGetLastError());
}

// The pre-pass, then the products at KC.
template <int KC>
int launch_kc(const Args& a, bool bytes16, cudaStream_t st) {
  const long long nchunk = (a.nb + CB - 1) / CB;
  split_panel_kernel<KC><<<static_cast<unsigned>(nchunk), PNT, 0, st>>>(
      a.x, reinterpret_cast<uint32_t*>(a.xs), a.nb);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return bytes16 ? start<KC, true>(a, st) : start<KC, false>(a, st);
}

}  // namespace s3

}  // namespace

// B1's arguments and the scratch panel: packed (p, nb) u8; cf0..cf2 (p,)
// f32; x (4*nb, kc) f32; xs the pre-split panel, ceil(nb / 32) * 8 * kc *
// 32 bf16 (written here); z (p, kc) f32.
extern "C" int fp_crossprod_split3(const void* packed, const void* cf0,
                                   const void* cf1, const void* cf2,
                                   const void* x, void* xs, void* z,
                                   long long p, long long nb, int kc,
                                   void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(xs) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const s3::Args a{static_cast<const uint8_t*>(packed),
                   static_cast<const float*>(cf0),
                   static_cast<const float*>(cf1),
                   static_cast<const float*>(cf2),
                   static_cast<const float*>(x),
                   static_cast<uint16_t*>(xs),
                   static_cast<float*>(z),
                   p,
                   nb};
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return s3::launch_kc<8>(a, bytes16, st);
    case 16: return s3::launch_kc<16>(a, bytes16, st);
    case 24: return s3::launch_kc<24>(a, bytes16, st);
    case 32: return s3::launch_kc<32>(a, bytes16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
