// B1's thread tile and chunk loop for z = W x. crossprod_v2.cu holds
// the design and why the sums are the first design's bit for bit.  B1
// instantiates them, and so do the kernel sweep's V2 (intsub) and V4
// (nocomp) in crossprod_variants_v2.cu, which differ from B1 only in the
// row values' arithmetic (V2) or the fold (V4).  There is one copy, so a
// change to B1's tile or loop is a change to both variants.
#pragma once

#include "common.cuh"

namespace b1 {

constexpr int CB = fp::kChunkBytes;  // bytes a chunk (128 samples): one fold
constexpr int BSTRIDE = CB + 16;     // byte-tile row stride: 12 words
constexpr int TM = 128;              // SNP rows a block

// One stage of the double buffer: a chunk's byte tile and x rows.
template <int TM_, int KC>
using Stage = fp::ChunkStage<TM_, BSTRIDE, KC>;

// A thread tile: TM_ rows a block, R rows and C columns a thread, TPS
// threads an SM that __launch_bounds__ asks for; NT threads a block
// (TM_ / R row slots x KC / C column groups) and SUMS, the bytes of the
// running sums in shared memory.
template <int KC_, int TM_, int R_, int C_, int TPS_>
struct Shape {
  static constexpr int KC = KC_, TM = TM_, R = R_, C = C_, TPS = TPS_;
  static_assert(KC % C == 0 && C % 4 == 0, "C must divide KC, 4 | C");
  static_assert(TM % (32 * R) == 0, "a warp takes 32 row slots");
  static constexpr int NT = TM / R * (KC / C);
  static constexpr int MIN_BLOCKS = TPS / NT > 0 ? TPS / NT : 1;
  static constexpr int SUMS = R * C * NT * 4;
};

// A tile of B1's loop (TM rows a block) with the running sum in
// registers (SREG = 1) or in shared memory (SREG = 0); SMEM, its dynamic
// shared memory: two stages and, at SREG = 0, the running sums.
template <int KC_, int R_, int C_, int TPS_, int SREG_>
struct LoopShape : Shape<KC_, TM, R_, C_, TPS_> {
  static constexpr int SREG = SREG_;
  static constexpr int SMEM = 2 * sizeof(Stage<TM, KC_>)
      + (SREG ? 0 : Shape<KC_, TM, R_, C_, TPS_>::SUMS);
};

// B1's tile at KC: 2 rows x C columns a thread (8 at KC 8 and 16, 12 at
// 24, 16 at 32), 768 threads an SM at KC <= 16 (80 registers a thread)
// and 384 above (up to 168), the running sum in shared memory.
template <int KC>
struct Tile : LoopShape<KC, 2, KC == 24 ? 12 : KC == 32 ? 16 : 8,
                        KC <= 16 ? 768 : 384, 0> {};

// Row ``gr``'s four decoded values (0 past row p): fp::decode_cubic of
// the b-coefficients, or with INTSUB fp::decode_intsub of the g ones.
template <bool INTSUB = false>
__device__ __forceinline__ void row_values(long long gr, long long p,
                                           const float* __restrict__ cf0,
                                           const float* __restrict__ cf1,
                                           const float* __restrict__ cf2,
                                           float (&t)[4]) {
  const bool live = gr < p;
  const float b0 = live ? cf0[gr] : 0.0f;
  const float b1 = live ? cf1[gr] : 0.0f;
  const float b2 = live ? cf2[gr] : 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    t[c] = INTSUB ? fp::decode_intsub(static_cast<uint32_t>(c), b0, b1, b2)
                  : fp::decode_cubic(static_cast<uint32_t>(c), b0, b1, b2);
}

// z rows slot + i * SLOTS, columns cg * C + [0, C): err(sum(i, c), i, c).
template <int KC, int R, int C, int SLOTS, typename Sum, typename Err>
__device__ __forceinline__ void write_out(float* __restrict__ z, long long p,
                                          long long row0, int slot, int cg,
                                          Sum sum, Err err) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = row0 + slot + i * SLOTS;
    if (row < p) {
      float4* out = reinterpret_cast<float4*>(z + row * KC + cg * C);
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        out[q] = make_float4(err(sum(i, 4 * q + 0), i, 4 * q + 0),
                             err(sum(i, 4 * q + 1), i, 4 * q + 1),
                             err(sum(i, 4 * q + 2), i, 4 * q + 2),
                             err(sum(i, 4 * q + 3), i, 4 * q + 3));
    }
  }
}

// The body of a kernel at tile T (a LoopShape): each row's four values
// (fp::decode_intsub with INTSUB, else fp::decode_cubic) computed once
// and a sample's w picked from them; the 32 lanes of a warp on 32
// consecutive rows of one column group; cp.async double buffering of
// 32-byte chunks; each chunk's partial folded into (sum, err) with
// TwoSum (COMP, B1's fold) or added plainly into sum; sum + err (COMP)
// or sum at the end.
template <int KC, typename T, bool INTSUB, bool COMP>
__device__ __forceinline__ void body(
    const uint8_t* __restrict__ packed, const float* __restrict__ cf0,
    const float* __restrict__ cf1, const float* __restrict__ cf2,
    const float* __restrict__ x, float* __restrict__ z, long long p,
    long long nb, bool bytes16, bool x16) {
  constexpr int R = T::R, C = T::C, NT = T::NT;
  constexpr int SLOTS = TM / R;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<TM, KC>* sg = reinterpret_cast<Stage<TM, KC>*>(smem);
  // at SREG = 0, sum[i][c] of thread tid at ssum[(i * C + c) * NT + tid]:
  // read and written once per chunk, by the fold
  float* ssum = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<TM, KC>));

  const int tid = threadIdx.x;
  // rows slot + i * SLOTS (i < R): 32 lanes take 32 consecutive rows
  const int slot = tid % SLOTS;
  const int cg = tid / SLOTS;
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;

  // each row's four decoded values, the same floats as decoding at
  // every sample
  float tab[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
    row_values<INTSUB>(row0 + slot + i * SLOTS, p, cf0, cf1, cf2, tab[i]);

  float sum[R][C], err[R][C], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (T::SREG) sum[i][c] = 0.0f;
      else ssum[(i * C + c) * NT + tid] = 0.0f;
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
    // with chunk ch - 1, whose buffer the next copies overwrite
    fp::cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < nchunk)
      fp::stage_chunk<TM, BSTRIDE, KC, NT>(sg[(ch + 1) & 1], packed, x, p,
                                           nb, row0, (ch + 1) * CB, bytes16,
                                           x16, tid);
    fp::cp_async_commit();

    const Stage<TM, KC>& cur = sg[ch & 1];
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
          float w[R];
#pragma unroll
          for (int i = 0; i < R; ++i)
            w[i] = fp::pick(wd[i][jj / 4], 8 * (jj % 4) + 2 * s, tab[i]);
          const float4* xr =
              reinterpret_cast<const float4*>(&cur.x[s][j][cg * C]);
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 xv = xr[q];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][4 * q + 0] = fmaf(w[i], xv.x, acc[i][4 * q + 0]);
              acc[i][4 * q + 1] = fmaf(w[i], xv.y, acc[i][4 * q + 1]);
              acc[i][4 * q + 2] = fmaf(w[i], xv.z, acc[i][4 * q + 2]);
              acc[i][4 * q + 3] = fmaf(w[i], xv.w, acc[i][4 * q + 3]);
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
        float s;
        if constexpr (T::SREG) s = sum[i][c];
        else s = ssum[o];
        float t;
        if constexpr (COMP) {
          float e;
          fp::two_sum(s, acc[i][c], t, e);
          err[i][c] = __fadd_rn(err[i][c], e);
        } else {
          t = __fadd_rn(s, acc[i][c]);
        }
        if constexpr (T::SREG) sum[i][c] = t;
        else ssum[o] = t;
        acc[i][c] = 0.0f;
      }
    }
  }

  write_out<KC, R, C, SLOTS>(
      z, p, row0, slot, cg,
      [&](int i, int c) {
        if constexpr (T::SREG) return sum[i][c];
        else return ssum[(i * C + c) * NT + tid];
      },
      [&](float s, int i, int c) {
        if constexpr (COMP) return __fadd_rn(s, err[i][c]);
        else return s;
      });
}

}  // namespace b1
