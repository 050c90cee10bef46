// B2 at one column: y = W^T v for one (p,) column v, the permuted-sample-
// space product of the packed standardized genotype matrix W (p SNPs x n4
// samples), each genotype decoded by the factored cubic.
//
// Serves flashpca_tpu/kernels/packed_matvec.py::_matvec_kernel at one
// column: the v-steps of a solo SCCA fit and every operator's vector
// prod.  B2 (matvec_v2.cu) computes the same function at kc 8-32; before
// this kernel a column was copied into a zeroed (p, 8) panel and B2 spent
// 32 FFMAs a row and thread on it, 28 of them on zeros (29.92 ms at
// 100,352 x 501,760, 8x the byte bound).
//
// Bound: the packed bytes, 12.6 GB at 3.35 TB/s, 3.76 ms at 100,352 x
// 501,760 (2*p*n4 operations take two fifths of that at 67 TFLOP/s, 1.50
// ms). No TF32, bf16 split or tensor cores: the check contract needs full
// float32 products.
//
// The sums are bit for bit column 0 of B2 at kc 8 on the zero-padded
// column.  For each output y[s*nb + b] both compute acc = fmaf(w, v[r],
// acc) over the rows r of a 64-row chunk in order, then two_sum(sum, acc)
// -> (sum, e) and err = err + e (rounded on its own), and write sum + err
// at the end; w is fp::decode_cubic(code, b0[r], b1[r], b2[r]), B2's
// table value.  Ragged edges take B2's padding (byte 0x55, zero
// coefficients and v past row p).
//
// Budget: a genotype needs its decode and one FFMA.  The integer pipe
// issues a warp instruction every two clocks, so a decode by selects (five
// integer instructions) would take 10 clocks a warp's 32 genotypes.  The
// decode is B2's table read: all lanes of a warp are on the same row at
// once, so the row's table is one broadcast row of shared memory, w(c) at
// word c and at word 4c (v at word 5), and a code's offset is the packed
// word shifted and masked in one LOP3 that also ORs in the stage's base
// (one shift serves two codes: masks 0xC and 0x30).  Per genotype and
// lane: 0.5 shift + 1 LOP3, 1 LDS (a wavefront: the four words of a row
// sit in four banks), 1 FFMA; the lane's bytes and v once a row.  Shared
// memory bounds it: ~1.1-1.3 wavefronts a genotype, 6.8 ms a wavefront
// each at 1.755 GHz.  Measured on an H100 (700 W): 10.2 ms at 100,352 x
// 501,760 against 29.4 ms for kc 8 on the padded column, 2.7x the byte
// bound; the compiled loop is 3.0 instructions a genotype (0.75 LOP3,
// 0.92 LDS, 1 FFMA, 0.22 SHF, the bytes' LDS.U16).
//
// Design:
// * Thread tile: G consecutive bytes a lane (4 G samples, 4 G outputs:
//   acc, sum and err in registers), the 32 lanes of a warp on 32 G
//   consecutive bytes; a block is NW warps, TB = 32 * G * NW bytes, grid
//   nb / TB.  No split-K (bit-identity forbids it).
// * Staging: double-buffered with cp.async one 64-row chunk at a time
//   (the 64 x TB byte tile; 16-byte copies where nb % 16 == 0, 4-byte
//   where nb % 4 == 0, bytes one by one otherwise), one barrier a chunk.
//   The table of chunk i+1 is decoded during chunk i, as in B2: its
//   rows' coefficients and v are loaded before the chunk's products and
//   decoded after, so the loads' latency hides behind the products.
// * Tile (tools/narrow_tiles.py, wide shape): G = 2, NW = 4 (256 bytes a
//   block, 490 blocks, all resident), TPS 512: 10.2 ms; G = 2, NW = 2
//   10.5, G = 4, NW = 2 10.3, G = 1 11.7-11.9.
//
// A source that defines MATVEC_NARROW_TILE_1 as "G, NW, TPS" and then
// includes this one builds the kernel at another tile:
// tools/narrow_tiles.py times other tiles that way.
#include "common.cuh"

#ifndef MATVEC_NARROW_TILE_1
#define MATVEC_NARROW_TILE_1 2, 4, 512
#endif

namespace {

namespace mvn {

constexpr int CR = 64;   // SNP rows a chunk: one stage, one fold (B2's)
constexpr int TW = 16;   // floats of a row's table: 64 bytes
constexpr uint32_t MASK_LO = 0xCu;   // code at bits 2-3: word c
constexpr uint32_t MASK_HI = 0x30u;  // code at bits 4-5: word 4c

// One stage of the double buffer: a chunk's decode tables (first, so each
// row's 64 bytes are 64-byte aligned in the stage) and its byte tile.
template <int TB>
struct Stage {
  float tab[CR][TW];
  uint8_t bytes[CR][TB];
};

// A tile: G bytes a lane, NW warps a block, TPS threads an SM that
// __launch_bounds__ asks for; NT threads and TB bytes a block, and the
// dynamic shared memory: two stages.
template <int KC, int G_, int NW_, int TPS_>
struct Shape {
  static_assert(KC == 1, "the one-column kernel");
  static_assert(G_ == 1 || G_ == 2 || G_ == 4, "a lane reads 1, 2 or 4 "
                "bytes of a row at once");
  static constexpr int G = G_, NW = NW_, TPS = TPS_;
  static constexpr int NT = 32 * NW;
  static constexpr int TB = 32 * G * NW;
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int SMEM = 2 * static_cast<int>(sizeof(Stage<TB>));
};

template <int KC>
struct Tile;
template <>
struct Tile<1> : Shape<1, MATVEC_NARROW_TILE_1> {};

template <int SH>
__device__ __forceinline__ uint32_t shifted(uint32_t w) {
  if constexpr (SH >= 0) return w >> SH;
  else return w << (-SH);
}

// Row ``tab``'s table from its coefficients (zero past p) and v: w(c) =
// fp::decode_cubic(c, b0, b1, b2) at word c and at word 4c, v at word 5.
__device__ __forceinline__ void put_row(float* tab, float b0, float b1,
                                        float b2, float v) {
  const float t0 = fp::decode_cubic(0u, b0, b1, b2);
  const float t1 = fp::decode_cubic(1u, b0, b1, b2);
  const float t2 = fp::decode_cubic(2u, b0, b1, b2);
  const float t3 = fp::decode_cubic(3u, b0, b1, b2);
  *reinterpret_cast<float4*>(tab) = make_float4(t0, t1, t2, t3);
  *reinterpret_cast<float2*>(tab + 4) = make_float2(t1, v);
  tab[8] = t2;
  tab[12] = t3;
}

// Start the copies of chunk rows [r0, r0 + CR) of bytes [byte0, byte0 +
// TB) into ``sg``: ``bmode`` 16 or 4 where the rows' bytes are that
// aligned; byte 0x55 past row p or byte nb, by plain stores.
template <int TB, int NT>
__device__ __forceinline__ void stage_chunk(
    Stage<TB>& sg, const uint8_t* __restrict__ packed, long long p,
    long long nb, long long byte0, long long r0, int bmode, int tid) {
  constexpr int GB = TB / 16;
  for (int idx = tid; idx < CR * GB; idx += NT) {
    const int r = idx / GB, q = idx % GB;
    const long long gr = r0 + r, gj = byte0 + 16 * q;
    uint8_t* dst = &sg.bytes[r][16 * q];
    if (gr < p && gj + 16 <= nb && bmode == 16) {
      fp::cp_async16(dst, packed + gr * nb + gj);
    } else if (gr < p && gj + 16 <= nb && bmode == 4) {
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        fp::cp_async4(dst + e, packed + gr * nb + gj + e);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gr < p && gj + e < nb) ? packed[gr * nb + gj + e]
                                         : fp::kMissingByte;
    }
  }
}

// The G bytes of row r that lane ``tid`` reads, as a word.
template <int G>
__device__ __forceinline__ uint32_t lane_bytes(const uint8_t* row, int tid) {
  if constexpr (G == 4) return *reinterpret_cast<const uint32_t*>(row + 4 * tid);
  else if constexpr (G == 2) return *reinterpret_cast<const uint16_t*>(row + 2 * tid);
  else return row[tid];
}

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
matvec_narrow_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ cf0,
                     const float* __restrict__ cf1,
                     const float* __restrict__ cf2,
                     const float* __restrict__ v, float* __restrict__ y,
                     long long p, long long nb, int bmode) {
  using T = Tile<KC>;
  constexpr int G = T::G, TB = T::TB, NT = T::NT;
  constexpr int U = 8;                        // rows unrolled
  constexpr int RPT = (CR + NT - 1) / NT;     // table rows a thread decodes
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<TB>* sg = reinterpret_cast<Stage<TB>*>(smem);

  const int tid = threadIdx.x;
  const long long byte0 = static_cast<long long>(blockIdx.x) * TB;

  float acc[G][4], sum[G][4], err[G][4];
#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[jj][s] = sum[jj][s] = err[jj][s] = 0.0f;
  }

  const long long nchunk = (p + CR - 1) / CR;
  stage_chunk<TB, NT>(sg[0], packed, p, nb, byte0, 0, bmode, tid);
  for (int r = tid; r < CR; r += NT) {
    const bool live = r < p;
    put_row(sg[0].tab[r], live ? cf0[r] : 0.0f, live ? cf1[r] : 0.0f,
            live ? cf2[r] : 0.0f, live ? v[r] : 0.0f);
  }
  fp::cp_async_commit();
#pragma unroll 1
  for (long long i = 0; i < nchunk; ++i) {
    // chunk i (and its table) has landed for every thread, and every
    // thread is done with chunk i - 1, whose buffer the next copies and
    // the next table overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    const bool more = i + 1 < nchunk;
    if (more)
      stage_chunk<TB, NT>(sg[(i + 1) & 1], packed, p, nb, byte0,
                          (i + 1) * CR, bmode, tid);
    fp::cp_async_commit();
    // the coefficients and v of chunk i + 1's rows: loaded now, decoded
    // into its table after this chunk's products
    float nb0[RPT], nb1[RPT], nb2[RPT], nv[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = tid + k * NT;
      const long long gr = (i + 1) * CR + r;
      const bool live = more && r < CR && gr < p;
      nb0[k] = live ? cf0[gr] : 0.0f;
      nb1[k] = live ? cf1[gr] : 0.0f;
      nb2[k] = live ? cf2[gr] : 0.0f;
      nv[k] = live ? v[gr] : 0.0f;
    }

    const Stage<TB>& cur = sg[i & 1];
    // the stage's offset in shared memory: a multiple of 64, so OR-ing a
    // code's word offset (bits 2-5) into it adds it
    const uint32_t sb = static_cast<uint32_t>((i & 1) * sizeof(Stage<TB>));
#pragma unroll 1
    for (int r0 = 0; r0 < CR; r0 += U) {
      const uint32_t rb = sb + static_cast<uint32_t>(r0 * TW * 4);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int r = r0 + k;
        const uint32_t wq = lane_bytes<G>(cur.bytes[r], tid);
        const float vr = cur.tab[r][5];
        const unsigned char* trow = smem + k * TW * 4;
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          // byte jj's codes: planes 0, 1 at bits 8jj, 8jj + 2 moved to
          // 2-3 and 4-5; planes 2, 3 likewise from 8jj + 4
          const uint32_t a = jj == 0 ? shifted<-2>(wq)
                           : jj == 1 ? shifted<6>(wq)
                           : jj == 2 ? shifted<14>(wq) : shifted<22>(wq);
          const uint32_t b = jj == 0 ? shifted<2>(wq)
                           : jj == 1 ? shifted<10>(wq)
                           : jj == 2 ? shifted<18>(wq) : shifted<26>(wq);
          acc[jj][0] = fmaf(*reinterpret_cast<const float*>(
                                trow + ((a & MASK_LO) | rb)),
                            vr, acc[jj][0]);
          acc[jj][1] = fmaf(*reinterpret_cast<const float*>(
                                trow + ((a & MASK_HI) | rb)),
                            vr, acc[jj][1]);
          acc[jj][2] = fmaf(*reinterpret_cast<const float*>(
                                trow + ((b & MASK_LO) | rb)),
                            vr, acc[jj][2]);
          acc[jj][3] = fmaf(*reinterpret_cast<const float*>(
                                trow + ((b & MASK_HI) | rb)),
                            vr, acc[jj][3]);
        }
      }
    }

    if (more) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = tid + k * NT;
        if (r < CR)
          put_row(sg[(i + 1) & 1].tab[r], nb0[k], nb1[k], nb2[k], nv[k]);
      }
    }

#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float t, e;
        fp::two_sum(sum[jj][s], acc[jj][s], t, e);
        sum[jj][s] = t;
        err[jj][s] = __fadd_rn(err[jj][s], e);
        acc[jj][s] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
    const long long gb = byte0 + static_cast<long long>(G) * tid + jj;
    if (gb < nb) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        y[s * nb + gb] = sum[jj][s] + err[jj][s];
    }
  }
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* c0, const float* c1,
              const float* c2, const float* vv, float* yy, long long p,
              long long nb, int bmode, cudaStream_t st) {
  using T = Tile<KC>;
  cudaError_t rc = cudaFuncSetAttribute(
      matvec_narrow_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(matvec_narrow_kernel<KC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((nb + T::TB - 1) / T::TB));
  matvec_narrow_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, c0, c1, c2, vv, yy, p, nb, bmode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mvn

}  // namespace

// B2 at one column. packed (p, nb) u8; cf0..cf2 (p,) f32; v (p,) f32; y
// (4*nb,) f32; kc must be 1.
extern "C" int fp_matvec_narrow(const void* packed, const void* cf0,
                                const void* cf1, const void* cf2,
                                const void* v, void* y, long long p,
                                long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0 || kc != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const int bmode = (nb % 16 == 0 && pa % 16 == 0) ? 16
                    : (nb % 4 == 0 && pa % 4 == 0) ? 4 : 1;
  return mvn::launch_kc<1>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(cf0),
      static_cast<const float*>(cf1), static_cast<const float*>(cf2),
      static_cast<const float*>(v), static_cast<float*>(y), p, nb, bmode,
      static_cast<cudaStream_t>(stream));
}
