// B1: z = W x, the SNP-space product of the packed standardized
// genotype matrix W (p SNPs x n4 permuted samples) with a panel x,
// decoded with the factored cubic (missing decodes to exactly 0) and
// accumulated in float32 FMAs, each 32-byte chunk's partial folded into
// a running (sum, err) pair with TwoSum.
//
// Replaces flashpca_tpu/kernels/packed_matvec.py::_crossprod_kernel.
// crossprod.cu keeps the first Hopper design of this function as
// fp_crossprod_v1, for comparison.
//
// Bound: float32 FMAs on the CUDA cores, 2*KC*p*n4 operations (the
// 12.6 GB of packed bytes take a fifth of that time at the memory rate).
// No TF32, bf16 split or tensor cores: the check contract needs full
// float32 products.
//
// The sums are bit for bit the first design's.  For each output z[row, c]
// both compute acc = fmaf(w(row, j, s), x[s][j][c], acc) over the bytes j
// of a 32-byte chunk in order and, within a byte, the planes s = 0..3;
// two_sum(sum, acc) and err += e at the chunk's end; sum + err at the
// end.  Only the mapping of outputs to threads and the staging differ.
//
// Design (the first design lost to occupancy and issue slots: one
// thread owned a row and all KC columns, 3*KC floats of state, 123
// registers at KC = 16 and 172 at KC = 32, 8-16 warps an SM, 196 blocks
// of 256 rows on the tall shape, and the cubic recomputed per sample):
// * Thread tile: R = 2 SNP rows x C columns, KC-independent: acc and err
//   in registers (2*R*C floats), the running sum in shared memory (read
//   and written once per chunk by the fold, thread-fastest).  A block is
//   TM = 128 rows: 64 row slots x KC / C column groups.  The 32 lanes of
//   a warp take 32 consecutive rows (slot, slot + 64) of one column
//   group, so each broadcast float4 of x feeds 2*4 FFMAs and the
//   byte-tile reads are conflict-free.
// * Decode: each row's four decoded values, fp::decode_cubic(t, b0, b1,
//   b2) for t = 0..3, are computed once per kernel into registers; a
//   sample's w is two bit tests and three selects on them (pick), the
//   same float as decoding at every sample.  Per sample and thread: R*C
//   FFMA, C/4 LDS.128 of x, 10 decode instructions.
// * Grid and occupancy: grid p / 128 (392 blocks at p = 50,176, 784 at
//   100,352).  __launch_bounds__ asks for TPS threads an SM:
//     KC   C  threads  TPS  reg. cap  blocks/SM  tall waves  wide waves
//      8   8     64    768     80         9         0.33        0.66
//     16   8    128    768     80         6         0.49        0.99
//     24  12    128    384    168         3         0.99        1.98
//     32  16    128    384    168         3         0.99        1.98
//   (blocks/SM by threads, registers and shared memory; waves = blocks
//   / (132 SMs x blocks/SM): every wave but a last partial one fills all
//   132 SMs, and no last wave is under 98% full.)  At KC = 16 the tall
//   shape has 12 warps an SM, the wide one 24.
// * Staging: double-buffered with cp.async (16-byte cp.async.cg) one
//   32-byte chunk at a time: the copies of chunk i+1 (the 128 x 32-byte
//   tile and the 4 x 32 x KC x-tile) are in flight while chunk i is
//   computed, with one barrier per chunk.  The byte tile's rows are 48
//   bytes apart, so a thread reads 16 bytes of its row in one load
//   without bank conflicts.  Ragged edges keep the first design's rule
//   -- byte 0x55 (four missing codes) and zero x rows -- written with
//   plain stores; rows whose bytes are not 16-byte aligned (nb % 16 !=
//   0) are staged byte by byte.
//
// The tile and the chunk loop are in b1_tile.cuh, which the kernel
// sweep's V2 and V4 (crossprod_variants_v2.cu) instantiate too.  The
// tiles tried on the card are named in PERF.md.
#include "b1_tile.cuh"

namespace {

namespace v2 {

constexpr int TM = b1::TM;  // SNP rows a block

// The tile at KC: its threads a block (NT), the blocks an SM that
// __launch_bounds__ asks for and its dynamic shared memory (SMEM).
template <int KC>
using Tile = b1::Tile<KC>;

template <int KC>
__global__ void __launch_bounds__(Tile<KC>::NT, Tile<KC>::MIN_BLOCKS)
crossprod_tile_kernel(const uint8_t* __restrict__ packed,
                      const float* __restrict__ cf0,
                      const float* __restrict__ cf1,
                      const float* __restrict__ cf2,
                      const float* __restrict__ x, float* __restrict__ z,
                      long long p, long long nb, bool bytes16, bool x16) {
  b1::body<KC, Tile<KC>, false, true>(packed, cf0, cf1, cf2, x, z, p, nb,
                                      bytes16, x16);
}

template <int KC>
int launch_kc(const uint8_t* pk, const float* c0, const float* c1,
              const float* c2, const float* xx, float* zz, long long p,
              long long nb, bool bytes16, bool x16, cudaStream_t st) {
  using T = Tile<KC>;
  const cudaError_t rc = cudaFuncSetAttribute(
      crossprod_tile_kernel<KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((p + TM - 1) / TM));
  crossprod_tile_kernel<KC><<<grid, T::NT, T::SMEM, st>>>(
      pk, c0, c1, c2, xx, zz, p, nb, bytes16, x16);
  return static_cast<int>(cudaGetLastError());
}

// Check the operands and launch at KC = kc.
int launch(const void* packed, const void* cf0, const void* cf1,
           const void* cf2, const void* x, void* z, long long p,
           long long nb, int kc, void* stream) {
  if (p <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* c0 = static_cast<const float*>(cf0);
  const auto* c1 = static_cast<const float*>(cf1);
  const auto* c2 = static_cast<const float*>(cf2);
  const auto* xx = static_cast<const float*>(x);
  auto* zz = static_cast<float*>(z);
  const bool bytes16 =
      nb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return launch_kc<8>(pk, c0, c1, c2, xx, zz, p, nb, bytes16, x16, st);
    case 16: return launch_kc<16>(pk, c0, c1, c2, xx, zz, p, nb, bytes16, x16, st);
    case 24: return launch_kc<24>(pk, c0, c1, c2, xx, zz, p, nb, bytes16, x16, st);
    case 32: return launch_kc<32>(pk, c0, c1, c2, xx, zz, p, nb, bytes16, x16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace v2

}  // namespace

// B1. packed (p, nb) u8; cf0..cf2 (p,) f32; x (4*nb, kc) f32; z (p, kc) f32.
extern "C" int fp_crossprod(const void* packed, const void* cf0,
                            const void* cf1, const void* cf2, const void* x,
                            void* z, long long p, long long nb, int kc,
                            void* stream) {
  return v2::launch(packed, cf0, cf1, cf2, x, z, p, nb, kc, stream);
}
