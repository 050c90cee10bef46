// B2: y = W^T v, the permuted-sample-space product of the packed
// standardized genotype matrix W (p SNPs x n4 samples) with an SNP-space
// panel v (p x KC), each genotype decoded by the factored cubic.
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_matvec_kernel.
// matvec.cu keeps the first Hopper design of this function as
// fp_matvec_v1, for comparison.
//
// Bound: float32 FMAs on the CUDA cores, one per genotype and column:
// 2*KC*p*n4 operations (at kc = 16 the 12.6 GB of packed bytes take a
// sixth of that time at the memory rate).  No TF32, bf16 split or tensor
// cores: the check contract needs full float32 products.
//
// The sums are bit for bit the first design's.  For each output y[s*nb +
// b, c] both compute acc = fmaf(w, v[r][c], acc) over the rows r of a
// 64-row chunk in order, then two_sum(sum, acc) -> (sum, e) and err =
// err + e (rounded on its own), and write sum + err at the end; w is
// fp::decode_cubic(code, b0[r], b1[r], b2[r]), a value that depends only
// on the code and the row's coefficients, wherever it is computed.
// Ragged edges take the same padding (byte 0x55, zero coefficients and v
// rows past p) through the same operations.  Only the mapping of outputs
// to threads, the decode's place and the staging differ.
//
// Design (the first design held one sample and all KC columns a thread:
// per row it loaded the byte and three coefficients and decoded its own
// sample for KC FMAs, four FFMA per shared-memory load, with plain
// staging and two barriers per chunk):
// * Thread tile: the four samples of one packed byte x C columns.  One
//   byte load gives the four codes; each broadcast float4 of v feeds 16
//   FFMAs.  A block is TB bytes x 4 planes x KC columns, its KC columns
//   split over KC / C thread groups (grid nb / TB, output (4 nb, KC) as
//   before); the 32 lanes of a warp take 32 consecutive bytes of one
//   column group, so the byte loads are conflict-free and the v loads
//   broadcast.
// * Decode by table: each staged row holds {w(0), w(1), w(2), w(3)},
//   filled by fp::decode_cubic once per row and chunk, so a sample's w is
//   one shared load at [row][code] (the four entries of a row sit on
//   four banks).  The table of chunk i+1 is decoded during chunk i: the
//   first CR threads load their row's three coefficients before the
//   chunk's products and decode them after, so the loads' latency hides
//   behind the products.  Per row and thread: 4*C FFMA, 1 byte load, 4
//   table loads, C/4 LDS.128 of v and ~8 integer ops (shifts and masks
//   of the code's address): ~68% FFMA at C = 8, ~79% at C = 16.
// * Registers and shared memory: the chunk partial acc (4*C floats)
//   lives in registers; the running sum in shared memory (4*C floats a
//   thread, thread-fastest, read and written once per chunk by the
//   fold); err in registers (EREG = 1) or beside the sum (EREG = 0).
//   Resident outputs cost 12 bytes each (acc, sum, err), so C trades the
//   FFMA share against the threads an SM holds.
// * Staging: double-buffered with cp.async one 64-row chunk at a time
//   (the byte tile and the v rows, 16-byte cp.async.cg): the copies of
//   chunk i+1 are in flight while chunk i is computed, with one barrier
//   per chunk.  Rows past p get byte 0x55 and zero v rows (and zero
//   coefficients, so their table is zero); bytes past nb get 0x55 and are
//   never written; rows whose bytes are not 16-byte aligned (nb % 16 !=
//   0) are staged byte by byte.
// * Grid and occupancy: without split-K (bit-identity forbids it) a
//   launch has nb * KC / C threads.  __launch_bounds__ asks for TPS
//   threads an SM.  Production tiles (C, TB, TPS, EREG):
//     KC   C  TB  threads  TPS  reg. cap  smem KB  blocks/SM  wide   tall
//      8   8  64     64    640     96       22         9      1.65   3.30
//     16  16 128    128    384    168       58         3      2.47   4.95
//     24  12  64    128    384    168       46         3      4.95   9.90
//     32  16  64    128    384    168       58         3      4.95   9.90
//   (blocks/SM by threads, the register cap and shared memory, 228 KB an
//   SM less 1 KB a block; the last two columns are waves, blocks / (132
//   SMs x blocks/SM), at nb = 125,440 (wide) and 250,880 (tall).)  On
//   the card C = 12-16 with err in registers beat the best C = 8 tile
//   (512-768 threads an SM) by 3-17%, at 166 and 156 registers and only
//   384 threads: the table loads and address ops weigh less per FFMA
//   (79% of the inner loop at C = 16, 69% at C = 8).  The tiles tried
//   are in PERF.md.
//
// A source that defines MATVEC_TILE_<KC> as "C, TB, TPS, EREG" and then
// includes this one builds B2 at another tile: tools/b2_tiles.py times
// other tiles that way.
#include "common.cuh"

#ifndef MATVEC_TILE_8
#define MATVEC_TILE_8 8, 64, 640, 1
#endif
#ifndef MATVEC_TILE_16
#define MATVEC_TILE_16 16, 128, 384, 1
#endif
#ifndef MATVEC_TILE_24
#define MATVEC_TILE_24 12, 64, 384, 1
#endif
#ifndef MATVEC_TILE_32
#define MATVEC_TILE_32 16, 64, 384, 1
#endif

namespace {

namespace mv2 {

constexpr int CR = 64;  // SNP rows a chunk: one stage, one fold (the first
                        // design's, which sets the fold points)

// One stage of the double buffer: a chunk's byte tile, v rows and decode
// tables.
template <int KC, int TB>
struct Stage {
  uint8_t bytes[CR][TB];
  float v[CR][KC];
  float w[CR][4];
};

// A tile: C columns a thread, TB bytes a block, TPS threads an SM, err in
// registers (EREG) or in shared memory; threads per block and the
// dynamic shared memory: two stages, then the running sums (and errs).
template <int KC_, int C_, int TB_, int TPS_, int EREG_>
struct Shape {
  static constexpr int KC = KC_, C = C_, TB = TB_, TPS = TPS_;
  static constexpr bool EREG = EREG_ != 0;
  static_assert(KC % C == 0 && C % 4 == 0, "C must divide KC, 4 | C");
  static_assert(TB % 32 == 0, "a warp takes 32 bytes");
  static constexpr int NT = TB * (KC / C);
  static_assert(NT >= CR, "one thread per row decodes the tables");
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int SMEM =
      2 * sizeof(Stage<KC, TB>) + (EREG ? 1 : 2) * 4 * C * NT * 4;
};

template <int KC>
struct Tile;
template <>
struct Tile<8> : Shape<8, MATVEC_TILE_8> {};
template <>
struct Tile<16> : Shape<16, MATVEC_TILE_16> {};
template <>
struct Tile<24> : Shape<24, MATVEC_TILE_24> {};
template <>
struct Tile<32> : Shape<32, MATVEC_TILE_32> {};

// Start the copies of chunk rows [r0, r0 + CR) into stage ``sg``.
template <int KC, int TB, int NT>
__device__ __forceinline__ void stage_chunk(
    Stage<KC, TB>& sg, const uint8_t* __restrict__ packed,
    const float* __restrict__ v, long long p, long long nb, long long byte0,
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
  constexpr int GV = KC / 4;
  for (int idx = tid; idx < CR * GV; idx += NT) {
    const int r = idx / GV;
    const int q = idx % GV;
    const long long gr = r0 + r;
    float* dst = &sg.v[r][4 * q];
    if (v16 && gr < p) {
      fp::cp_async16(dst, v + gr * KC + 4 * q);
    } else {
      for (int e = 0; e < 4; ++e)
        dst[e] = gr < p ? v[gr * KC + 4 * q + e] : 0.0f;
    }
  }
}

// The decode table of one row from its coefficients: w(code) for codes
// 0..3, each the value fp::decode_cubic gives (zero coefficients past p).
__device__ __forceinline__ float4 decode_row(float b0, float b1, float b2) {
  return make_float4(fp::decode_cubic(0u, b0, b1, b2),
                     fp::decode_cubic(1u, b0, b1, b2),
                     fp::decode_cubic(2u, b0, b1, b2),
                     fp::decode_cubic(3u, b0, b1, b2));
}

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
matvec_tile_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ cf0, const float* __restrict__ cf1,
                   const float* __restrict__ cf2, const float* __restrict__ v,
                   float* __restrict__ y, long long p, long long nb,
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

  float acc[4][C], err[4][C];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ssum[(s * C + c) * NT + tid] = 0.0f;
      if constexpr (!T::EREG) serr[(s * C + c) * NT + tid] = 0.0f;
      err[s][c] = 0.0f;
      acc[s][c] = 0.0f;
    }
  }

  const long long nchunk = (p + CR - 1) / CR;
  stage_chunk<KC, TB, NT>(sg[0], packed, v, p, nb, byte0, 0, bytes16, v16,
                          tid);
  if (tid < CR) {
    const bool live = tid < p;
    *reinterpret_cast<float4*>(&sg[0].w[tid][0]) =
        decode_row(live ? cf0[tid] : 0.0f, live ? cf1[tid] : 0.0f,
                   live ? cf2[tid] : 0.0f);
  }
  fp::cp_async_commit();
  for (long long i = 0; i < nchunk; ++i) {
    // chunk i (and its table) has landed for every thread, and every
    // thread is done with chunk i - 1, whose buffer the next copies and
    // the next table overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    const bool more = i + 1 < nchunk;
    if (more)
      stage_chunk<KC, TB, NT>(sg[(i + 1) & 1], packed, v, p, nb, byte0,
                              (i + 1) * CR, bytes16, v16, tid);
    fp::cp_async_commit();
    // the coefficients of chunk i + 1's rows, one row a thread: loaded
    // now, decoded into its table after this chunk's products
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    const long long gr = (i + 1) * CR + tid;
    if (more && tid < CR && gr < p) {
      b0 = cf0[gr];
      b1 = cf1[gr];
      b2 = cf2[gr];
    }

    const Stage<KC, TB>& cur = sg[i & 1];
#pragma unroll 16
    for (int r = 0; r < CR; ++r) {
      const uint32_t byte = cur.bytes[r][bb];
      const float4* vr = reinterpret_cast<const float4*>(&cur.v[r][cg * C]);
      float vv[C];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 a = vr[q];
        vv[4 * q + 0] = a.x;
        vv[4 * q + 1] = a.y;
        vv[4 * q + 2] = a.z;
        vv[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float w = cur.w[r][(byte >> (2 * s)) & 3u];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[s][c] = fmaf(w, vv[c], acc[s][c]);
      }
    }

    if (more && tid < CR)
      *reinterpret_cast<float4*>(&sg[(i + 1) & 1].w[tid][0]) =
          decode_row(b0, b1, b2);

#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (s * C + c) * NT + tid;
        float t, e;
        fp::two_sum(ssum[o], acc[s][c], t, e);
        ssum[o] = t;
        if constexpr (T::EREG)
          err[s][c] = __fadd_rn(err[s][c], e);
        else
          serr[o] = __fadd_rn(serr[o], e);
        acc[s][c] = 0.0f;
      }
    }
  }

  const long long gb = byte0 + bb;
  if (gb < nb) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float4* out = reinterpret_cast<float4*>(
          y + (static_cast<long long>(s) * nb + gb) * KC + cg * C);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = (s * C + 4 * q + j) * NT + tid;
          o[j] = ssum[idx] + (T::EREG ? err[s][4 * q + j] : serr[idx]);
        }
        out[q] = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* c0, const float* c1,
              const float* c2, const float* vv, float* yy, long long p,
              long long nb, bool bytes16, bool v16, cudaStream_t st) {
  using T = Tile<KC>;
  cudaError_t rc = cudaFuncSetAttribute(
      matvec_tile_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(matvec_tile_kernel<KC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((nb + T::TB - 1) / T::TB));
  matvec_tile_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, c0, c1, c2, vv, yy, p, nb, bytes16, v16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mv2

}  // namespace

// B2. packed (p, nb) u8; cf0..cf2 (p,) f32; v (p, kc) f32; y (4*nb, kc)
// f32.
extern "C" int fp_matvec(const void* packed, const void* cf0, const void* cf1,
                         const void* cf2, const void* v, void* y, long long p,
                         long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* c0 = static_cast<const float*>(cf0);
  const auto* c1 = static_cast<const float*>(cf1);
  const auto* c2 = static_cast<const float*>(cf2);
  const auto* vv = static_cast<const float*>(v);
  auto* yy = static_cast<float*>(y);
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool v16 = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return mv2::launch_kc<8>(pk, c0, c1, c2, vv, yy, p, nb, bytes16, v16, st);
    case 16: return mv2::launch_kc<16>(pk, c0, c1, c2, vv, yy, p, nb, bytes16, v16, st);
    case 24: return mv2::launch_kc<24>(pk, c0, c1, c2, vv, yy, p, nb, bytes16, v16, st);
    case 32: return mv2::launch_kc<32>(pk, c0, c1, c2, vv, yy, p, nb, bytes16, v16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
