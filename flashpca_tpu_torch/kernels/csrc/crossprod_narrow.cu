// B1 at one column: z = W x for one (n4,) column x, the SNP-space product
// of the packed standardized genotype matrix W (p SNPs x n4 permuted
// samples), decoded with the factored cubic (missing decodes to exactly
// 0) and accumulated in float32 FMAs, each 32-byte chunk's partial folded
// into a running (sum, err) pair with TwoSum.
//
// Serves flashpca_tpu/kernels/packed_matvec.py::_crossprod_kernel at one
// column: the products of a solo SCCA fit and every operator's vector
// crossprod.  B1 (crossprod_v2.cu) computes the same function at kc 8-32;
// before this kernel a column was copied into a zeroed (n4, 8) panel and
// B1 did all eight columns of work (30.00 ms at 100,352 x 501,760, 8x
// the byte bound).
//
// Bound: the packed bytes, 12.6 GB at 3.35 TB/s, 3.76 ms at 100,352 x
// 501,760 (2*p*n4 operations take two fifths of that at 67 TFLOP/s, 1.50
// ms). No TF32, bf16 split or tensor cores: the check contract needs full
// float32 products.
//
// The sums are bit for bit column 0 of B1 at kc 8 on the zero-padded
// column.  For each output z[row] both compute acc = fmaf(w(row, j, s),
// x[s][j], acc) over the bytes j of a 32-byte chunk in order and, within a
// byte, the planes s = 0..3; two_sum(sum, acc) and err += e at the chunk's
// end; sum + err at the end.  w is b1::row_values' t[code], the same four
// floats B1 picks from.  Ragged edges take B1's padding (byte 0x55, zero x
// past byte nb).
//
// Budget: a genotype needs its decode and one FFMA.  The FFMA pipe takes
// a warp instruction a clock and sub-partition, the integer pipe (shifts,
// LOP3, selects, predicates) one every two, shared memory 128 bytes a
// clock and SM.  B1's pick (two bit tests, three selects) is five integer
// instructions a genotype: 10 clocks a warp's 32 genotypes, ~17 ms here.
// So the decode is a table read instead: each row's four values sit in
// shared memory at [code][lane] (lanes in distinct banks), and a code's
// word offset is the packed word shifted and masked in one LOP3 that also
// ORs in the lane's base.  One shift serves two codes (masks 0x180 and
// 0x600: the table holds w(c) at c * 128 and at c * 512 bytes).  Per
// genotype and lane: 0.5 shift + 1 LOP3 (1.5 integer, 3 clocks), 1 LDS (a
// wavefront: 4 clocks a sub-partition's share), 1 FFMA; x comes as a
// broadcast float4 per plane and 4 bytes, shared by the lane's R rows.
// Shared memory bounds it: ~1.1-1.4 wavefronts a genotype, 6.8 ms a
// wavefront each at 1.755 GHz.  Measured on an H100 (700 W): 10.1 ms at
// 100,352 x 501,760 against 29.4 ms for kc 8 on the padded column, 2.7x
// the byte bound; the compiled loop is 3.55 instructions a genotype
// (LOP3, LDS, FFMA, 0.34 SHF, the x and byte LDS.128s).  Plane 3 by
// fp::pick from registers (a quarter fewer table reads, 1.25 more integer
// instructions a genotype) measured slower, 10.8 ms.
//
// Design:
// * Thread tile: R SNP rows a lane, the 32 lanes of a warp on 32
//   consecutive rows; a block is NW warps, TM = 32 * R * NW rows.  Each
//   row's chain is serial over all samples (no split-K: the bits forbid
//   it), so the rows are the only parallel axis: 100,352 lanes here.
// * Staging: double-buffered with cp.async one 32-byte chunk at a time
//   (the TM x 32-byte tile, rows 48 bytes apart so a lane's 16-byte read
//   is conflict-free, and the 4 x 32 floats of x), one barrier a chunk;
//   16-byte copies where nb % 16 == 0, 4-byte where nb % 4 == 0, bytes
//   one by one otherwise.
// * Tables: R * NW of 2 KB at the front of shared memory, written once by
//   their own lanes (no barrier: a lane reads only its own entries).
// * Tile (tools/narrow_tiles.py, wide shape): R = 2, NW = 4 (256 rows a
//   block, 392 blocks, 3 an SM: one wave), TPS 512 (no spill at 103
//   registers): 10.1 ms; R = 1 at 64 registers spills and takes 11.7-12.0
//   ms, R = 3 11.0, R = 4 11.8.  On few rows (an 8,559-SNP streamed
//   block) R = 1, NW = 2 fills more SMs: 3.7 ms against 4.8.
//
// A source that defines CROSSPROD_NARROW_TILE_1 as "R, NW, TPS" and then
// includes this one builds the kernel at another tile:
// tools/narrow_tiles.py times other tiles that way.
#include "b1_tile.cuh"

#ifndef CROSSPROD_NARROW_TILE_1
#define CROSSPROD_NARROW_TILE_1 2, 4, 512
#endif

namespace {

namespace b1n {

constexpr int CB = fp::kChunkBytes;  // bytes a chunk (128 samples): one fold
constexpr int BSTRIDE = b1::BSTRIDE;  // byte-tile row stride: 48 bytes
constexpr int TABLE = 2048;           // bytes of one row slot's table
constexpr uint32_t MASK_LO = 0x180u;  // code at bits 7-8: c * 128 bytes
constexpr uint32_t MASK_HI = 0x600u;  // code at bits 9-10: c * 512 bytes

template <int TM>
struct Stage {
  uint8_t bytes[TM][BSTRIDE];
  float x[4][CB];
};

// A tile: R rows a lane, NW warps a block, TPS threads an SM that
// __launch_bounds__ asks for; NT threads and TM rows a block, and the
// dynamic shared memory: the tables, then two stages.
template <int KC, int R_, int NW_, int TPS_>
struct Shape {
  static_assert(KC == 1, "the one-column kernel");
  static constexpr int R = R_, NW = NW_, TPS = TPS_;
  static constexpr int NT = 32 * NW;
  static constexpr int TM = 32 * R * NW;
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int TABLES = R * NW * TABLE;
  static constexpr int SMEM = TABLES + 2 * static_cast<int>(sizeof(Stage<TM>));
};

template <int KC>
struct Tile;
template <>
struct Tile<1> : Shape<1, CROSSPROD_NARROW_TILE_1> {};

// ``w`` shifted right by SH bits (left by -SH).
template <int SH>
__device__ __forceinline__ uint32_t shifted(uint32_t w) {
  if constexpr (SH >= 0) return w >> SH;
  else return w << (-SH);
}

__device__ __forceinline__ float table(const unsigned char* smem,
                                       uint32_t off) {
  return *reinterpret_cast<const float*>(smem + off);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Start the copies of chunk [base, base + 32) of rows [row0, row0 + TM)
// and of x's four planes there.  ``bmode`` 16 or 4: the rows' bytes are
// that aligned; x16: x's planes are 16-byte aligned.  Past row p or byte
// nb: byte 0x55 (four missing codes) and zero x, by plain stores.
template <int TM, int NT>
__device__ __forceinline__ void stage_chunk(
    Stage<TM>& sg, const uint8_t* __restrict__ packed,
    const float* __restrict__ x, long long p, long long nb, long long row0,
    long long base, int bmode, bool x16, int tid) {
  const bool full = base + CB <= nb;
  if (full && bmode == 16) {
    for (int idx = tid; idx < TM * (CB / 16); idx += NT) {
      const int r = idx / (CB / 16), q = idx % (CB / 16);
      const long long gr = row0 + r;
      uint8_t* dst = &sg.bytes[r][16 * q];
      if (gr < p)
        fp::cp_async16(dst, packed + gr * nb + base + 16 * q);
      else
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(0x55555555u, 0x55555555u, 0x55555555u, 0x55555555u);
    }
  } else if (full && bmode == 4) {
    for (int idx = tid; idx < TM * (CB / 4); idx += NT) {
      const int r = idx / (CB / 4), q = idx % (CB / 4);
      const long long gr = row0 + r;
      uint8_t* dst = &sg.bytes[r][4 * q];
      if (gr < p)
        fp::cp_async4(dst, packed + gr * nb + base + 4 * q);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0x55555555u;
    }
  } else {
    for (int idx = tid; idx < TM * CB; idx += NT) {
      const int r = idx / CB, e = idx % CB;
      const long long gr = row0 + r, gb = base + e;
      sg.bytes[r][e] = (gr < p && gb < nb) ? packed[gr * nb + gb]
                                           : fp::kMissingByte;
    }
  }
  if (full && x16) {
    for (int idx = tid; idx < 4 * (CB / 4); idx += NT) {
      const int s = idx / (CB / 4), q = idx % (CB / 4);
      fp::cp_async16(&sg.x[s][4 * q], x + s * nb + base + 4 * q);
    }
  } else {
    for (int idx = tid; idx < 4 * CB; idx += NT) {
      const int s = idx / CB, j = idx % CB;
      const long long gb = base + j;
      if (gb < nb)
        fp::cp_async4(&sg.x[s][j], x + s * nb + gb);
      else
        sg.x[s][j] = 0.0f;
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
crossprod_narrow_kernel(const uint8_t* __restrict__ packed,
                        const float* __restrict__ cf0,
                        const float* __restrict__ cf1,
                        const float* __restrict__ cf2,
                        const float* __restrict__ x, float* __restrict__ z,
                        long long p, long long nb, int bmode, bool x16) {
  using T = Tile<KC>;
  constexpr int R = T::R, TM = T::TM, NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<TM>* sg = reinterpret_cast<Stage<TM>*>(smem + T::TABLES);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;
  // the lane's rows in the block: warp * 32 * R + i * 32 + lane
  const int rbase = warp * 32 * R + lane;

  // each row's four decoded values, B1's own floats, in the lane's
  // column of its table: w(c) at c * 128 and at c * 512 bytes (w(0) once)
  uint32_t lb[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lb[i] = static_cast<uint32_t>((warp * R + i) * TABLE + 4 * lane);
    float t[4];
    b1::row_values<false>(row0 + rbase + 32 * i, p, cf0, cf1, cf2, t);
    *reinterpret_cast<float*>(smem + lb[i]) = t[0];
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      *reinterpret_cast<float*>(smem + lb[i] + c * 128) = t[c];
      *reinterpret_cast<float*>(smem + lb[i] + c * 512) = t[c];
    }
  }

  float sum[R], err[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] = err[i] = acc[i] = 0.0f;

  const long long nchunk = (nb + CB - 1) / CB;
  stage_chunk<TM, NT>(sg[0], packed, x, p, nb, row0, 0, bmode, x16, tid);
  fp::cp_async_commit();
#pragma unroll 1
  for (long long ch = 0; ch < nchunk; ++ch) {
    // chunk ch has landed for every thread, and every thread is done
    // with chunk ch - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < nchunk)
      stage_chunk<TM, NT>(sg[(ch + 1) & 1], packed, x, p, nb, row0,
                          (ch + 1) * CB, bmode, x16, tid);
    fp::cp_async_commit();

    const Stage<TM>& cur = sg[ch & 1];
#pragma unroll
    for (int h = 0; h < CB / 16; ++h) {
      uint4 wd[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        wd[i] = *reinterpret_cast<const uint4*>(
            &cur.bytes[rbase + 32 * i][16 * h]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // x of bytes 16h + 4q + [0, 4), one float4 a plane
        float4 xs[4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          xs[s] = *reinterpret_cast<const float4*>(&cur.x[s][16 * h + 4 * q]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const uint32_t wq = comp(wd[i], q);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            // byte jj's codes: planes 0, 1 at bits 8jj, 8jj + 2 moved to
            // 7-8 and 9-10; planes 2, 3 likewise from 8jj + 4
            const uint32_t a = jj == 0 ? shifted<-7>(wq)
                             : jj == 1 ? shifted<1>(wq)
                             : jj == 2 ? shifted<9>(wq) : shifted<17>(wq);
            const uint32_t b = jj == 0 ? shifted<-3>(wq)
                             : jj == 1 ? shifted<5>(wq)
                             : jj == 2 ? shifted<13>(wq) : shifted<21>(wq);
            acc[i] = fmaf(table(smem, (a & MASK_LO) | lb[i]),
                          comp(xs[0], jj), acc[i]);
            acc[i] = fmaf(table(smem, (a & MASK_HI) | lb[i]),
                          comp(xs[1], jj), acc[i]);
            acc[i] = fmaf(table(smem, (b & MASK_LO) | lb[i]),
                          comp(xs[2], jj), acc[i]);
            acc[i] = fmaf(table(smem, (b & MASK_HI) | lb[i]),
                          comp(xs[3], jj), acc[i]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float t, e;
      fp::two_sum(sum[i], acc[i], t, e);
      sum[i] = t;
      err[i] = __fadd_rn(err[i], e);
      acc[i] = 0.0f;
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = row0 + rbase + 32 * i;
    if (row < p) z[row] = __fadd_rn(sum[i], err[i]);
  }
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* c0, const float* c1,
              const float* c2, const float* xx, float* zz, long long p,
              long long nb, int bmode, bool x16, cudaStream_t st) {
  using T = Tile<KC>;
  const cudaError_t rc = cudaFuncSetAttribute(
      crossprod_narrow_kernel<KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((p + T::TM - 1) / T::TM));
  crossprod_narrow_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, c0, c1, c2, xx, zz, p, nb, bmode, x16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b1n

}  // namespace

// B1 at one column. packed (p, nb) u8; cf0..cf2 (p,) f32; x (4*nb,) f32;
// z (p,) f32; kc must be 1.
extern "C" int fp_crossprod_narrow(const void* packed, const void* cf0,
                                   const void* cf1, const void* cf2,
                                   const void* x, void* z, long long p,
                                   long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0 || kc != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const int bmode = (nb % 16 == 0 && pa % 16 == 0) ? 16
                    : (nb % 4 == 0 && pa % 4 == 0) ? 4 : 1;
  const bool x16 = nb % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return b1n::launch_kc<1>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(cf0),
      static_cast<const float*>(cf1), static_cast<const float*>(cf2),
      static_cast<const float*>(x), static_cast<float*>(z), p, nb, bmode,
      x16, static_cast<cudaStream_t>(stream));
}
