// V3 ("split3"): B1's z = W x with every product taken on the tensor
// cores as three bf16 products with float32 accumulation,
// wh xh + wh xl + wl xh (the lo * lo term dropped), for the kernel sweep
// (tools/kernel_sweep.py).  This is V3's first design, kept for
// comparison as fp_crossprod_split3_v1: crossprod_split3_v2.cu holds its
// redesign, bit for bit these sums.
//
// Replaces .claude/skills/verify/kernel_sweep.py::_crossprod_kernel_split3
// (its _split_bf16 and _dot3).
//
// Bound: the decode and the bf16 split on the CUDA cores.  The three bf16
// products need 6*KC*p*n4 operations at 989 TFLOP/s (4.9 ms at KC = 16 on
// the wide headline) and the packed bytes 3.8 ms, while each genotype
// costs 9 CUDA-core instructions (code to float; the factored cubic's
// sub, 2 muls, 2 adds and mul, rounded one by one as the plain version
// rounds them; the split's sub and one paired conversion per piece, half
// an instruction per value each), 13.5 ms at 33.5 T instructions/s.
//
// Design: mma.sync.m16n8k16 (bf16 in, f32 accumulate) with M = 16 SNP
// rows, N = 8 panel columns (KC / 8 n-tiles), K = 16 samples of one
// plane.  A block of 8 warps owns 128 SNP rows, a warp 16 of them, and
// walks the whole byte axis in CB-byte chunks (nothing carried between
// blocks).  Per chunk the block stages the packed tile and the panel rows
// in shared memory, the panel split once into bf16 hi/lo planes stored
// column-major (sample pairs are one 32-bit word, as the B fragment
// wants).  Each thread decodes exactly the genotypes of its own A
// fragments -- rows g and g + 8 of its warp's tile, samples 2t, 2t + 1,
// 2t + 8, 2t + 9 of each 16-sample step, all four planes from the same
// bytes -- splits them in registers and issues the three products per
// n-tile.  Each chunk's accumulator is folded into a (sum, err) pair per
// C element with TwoSum, as the TPU kernel folds per byte tile.
#include "common.cuh"

namespace {

constexpr int NW = 8;              // warps per block
constexpr int TM = 16 * NW;        // SNP rows per block
constexpr int NT = 32 * NW;        // threads per block
constexpr int CB = 32;             // packed bytes per chunk (2 k16 steps x 4 planes)
constexpr int PSTRIDE = CB + 4;    // packed row stride (bytes)
constexpr int XS = CB + 8;         // bf16 panel row stride: 20 words -> B loads conflict-free

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KC>
__global__ void __launch_bounds__(NT)
split_kernel(const uint8_t* __restrict__ packed,
             const float* __restrict__ cf0, const float* __restrict__ cf1,
             const float* __restrict__ cf2, const float* __restrict__ x,
             float* __restrict__ z, long long p, long long nb) {
  __shared__ __align__(16) uint8_t ptile[TM * PSTRIDE];
  __shared__ __align__(16) uint16_t xh[4][KC][XS];   // bf16 bits, [plane][column][sample]
  __shared__ __align__(16) uint16_t xl[4][KC][XS];
  constexpr int NTILES = KC / 8;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;          // fragment row group
  const int t = lane % 4;          // thread in group
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;
  const int ra = warp * 16 + g;    // local rows of this thread's A fragments
  const int rb = ra + 8;
  const long long gra = row0 + ra;
  const long long grb = row0 + rb;
  const float a0 = gra < p ? cf0[gra] : 0.0f;
  const float a1 = gra < p ? cf1[gra] : 0.0f;
  const float a2 = gra < p ? cf2[gra] : 0.0f;
  const float b0 = grb < p ? cf0[grb] : 0.0f;
  const float b1 = grb < p ? cf1[grb] : 0.0f;
  const float b2 = grb < p ? cf2[grb] : 0.0f;

  float sum[NTILES][4], err[NTILES][4], acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum[n][i] = 0.0f;
      err[n][i] = 0.0f;
      acc[n][i] = 0.0f;
    }

  for (long long base = 0; base < nb; base += CB) {
    for (int idx = tid; idx < TM * CB; idx += NT) {
      const int r = idx / CB;
      const int j = idx % CB;
      const long long gr = row0 + r;
      const long long gb = base + j;
      uint8_t v = fp::kMissingByte;
      if (gr < p && gb < nb) v = packed[gr * nb + gb];
      ptile[r * PSTRIDE + j] = v;
    }
    // the panel rows of the chunk, split once into bf16 hi/lo
    for (int idx = tid; idx < 4 * CB * KC; idx += NT) {
      const int s = idx / (CB * KC);
      const int rem = idx % (CB * KC);
      const int j = rem / KC;
      const int c = rem % KC;
      const long long gb = base + j;
      const float v =
          gb < nb ? x[(static_cast<long long>(s) * nb + gb) * KC + c] : 0.0f;
      __nv_bfloat16 h, l;
      fp::split_bf16(v, h, l);
      xh[s][c][j] = __bfloat16_as_ushort(h);
      xl[s][c][j] = __bfloat16_as_ushort(l);
    }
    __syncthreads();

#pragma unroll
    for (int j0 = 0; j0 < CB; j0 += 16) {
      // this thread's bytes: rows ra, rb at j0 + {2t, 2t+1} and j0 + {2t+8, 2t+9}
      const int k0 = j0 + 2 * t;
      const uint32_t pa0 = *reinterpret_cast<const uint16_t*>(&ptile[ra * PSTRIDE + k0]);
      const uint32_t pa8 = *reinterpret_cast<const uint16_t*>(&ptile[ra * PSTRIDE + k0 + 8]);
      const uint32_t pb0 = *reinterpret_cast<const uint16_t*>(&ptile[rb * PSTRIDE + k0]);
      const uint32_t pb8 = *reinterpret_cast<const uint16_t*>(&ptile[rb * PSTRIDE + k0 + 8]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int sh = 2 * s;
        // A fragment (row-major 16 x 16): reg0 row g, k 2t..2t+1; reg1 row
        // g+8, k 2t..2t+1; reg2 row g, k 2t+8..; reg3 row g+8, k 2t+8..
        uint32_t ah[4], al[4];
        fp::split_bf16x2(fp::decode_cubic_rn((pa0 >> sh) & 3u, a0, a1, a2),
                         fp::decode_cubic_rn((pa0 >> (8 + sh)) & 3u, a0, a1, a2),
                         ah[0], al[0]);
        fp::split_bf16x2(fp::decode_cubic_rn((pb0 >> sh) & 3u, b0, b1, b2),
                         fp::decode_cubic_rn((pb0 >> (8 + sh)) & 3u, b0, b1, b2),
                         ah[1], al[1]);
        fp::split_bf16x2(fp::decode_cubic_rn((pa8 >> sh) & 3u, a0, a1, a2),
                         fp::decode_cubic_rn((pa8 >> (8 + sh)) & 3u, a0, a1, a2),
                         ah[2], al[2]);
        fp::split_bf16x2(fp::decode_cubic_rn((pb8 >> sh) & 3u, b0, b1, b2),
                         fp::decode_cubic_rn((pb8 >> (8 + sh)) & 3u, b0, b1, b2),
                         ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NTILES; ++n) {
          // B fragment (column-major 16 x 8): reg0 k 2t..2t+1, reg1 k
          // 2t+8..2t+9, both of column g
          const int col = n * 8 + g;
          const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(&xh[s][col][k0]);
          const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(&xh[s][col][k0 + 8]);
          const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(&xl[s][col][k0]);
          const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(&xl[s][col][k0 + 8]);
          mma_bf16(acc[n], ah, bh0, bh1);   // wh xh
          mma_bf16(acc[n], ah, bl0, bl1);   // wh xl
          mma_bf16(acc[n], al, bh0, bh1);   // wl xh
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e;
        fp::two_sum(sum[n][i], acc[n][i], sum[n][i], e);
        err[n][i] = __fadd_rn(err[n][i], e);
        acc[n][i] = 0.0f;
      }
  }

  // C fragment: c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int col = n * 8 + 2 * t;
    if (gra < p)
      *reinterpret_cast<float2*>(z + gra * KC + col) =
          make_float2(sum[n][0] + err[n][0], sum[n][1] + err[n][1]);
    if (grb < p)
      *reinterpret_cast<float2*>(z + grb * KC + col) =
          make_float2(sum[n][2] + err[n][2], sum[n][3] + err[n][3]);
  }
}

}  // namespace

// B1's arguments: packed (p, nb) u8; cf0..cf2 (p,) f32; x (4*nb, kc) f32;
// z (p, kc) f32.
extern "C" int fp_crossprod_split3_v1(const void* packed, const void* cf0,
                                      const void* cf1, const void* cf2,
                                      const void* x, void* z, long long p,
                                      long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + TM - 1) / TM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* c0 = static_cast<const float*>(cf0);
  const auto* c1 = static_cast<const float*>(cf1);
  const auto* c2 = static_cast<const float*>(cf2);
  const auto* xx = static_cast<const float*>(x);
  auto* zz = static_cast<float*>(z);
  switch (kc) {
    case 8: split_kernel<8><<<grid, NT, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 16: split_kernel<16><<<grid, NT, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 24: split_kernel<24><<<grid, NT, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    case 32: split_kernel<32><<<grid, NT, 0, st>>>(pk, c0, c1, c2, xx, zz, p, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
