// B5 (matvec_ff_novl.cu) at two other tiles, for the comparison in
// chip_smoke.py; no operator launches them, and production B5's
// library does not hold them.
//
// * fp_matvec_ff_novl_c4: C = 4 columns per thread, CR = 64 rows per
//   chunk -- half the accumulators of production's C = 8, twice the
//   threads per block, and 6 shared-memory instructions per 32 FFMAs
//   instead of 7 per 64.
// * fp_matvec_ff_novl_cr128: C = 8, CR = 128 -- half the chunks, so
//   half the barriers, folds and staging rounds, but each uncompensated
//   float32 partial runs over twice the rows before its TwoSum fold.
//   Its pairs therefore move against production's, and chip_smoke.py
//   holds its tall gram against float64 as it does production's.
//
// Same function, operands and layout as fp_matvec_ff_novl.
#define MATVEC_FF_NOVL_NO_ENTRY
#include "matvec_ff_novl.cu"

extern "C" int fp_matvec_ff_novl_c4(const void* packed, const void* lut6,
                                    const void* vh, void* yh, void* yl,
                                    long long p, long long nb, int kc,
                                    void* stream) {
  return launch<4, 64>(packed, lut6, vh, yh, yl, p, nb, kc, stream);
}

extern "C" int fp_matvec_ff_novl_cr128(const void* packed, const void* lut6,
                                       const void* vh, void* yh, void* yl,
                                       long long p, long long nb, int kc,
                                       void* stream) {
  return launch<8, 128>(packed, lut6, vh, yh, yl, p, nb, kc, stream);
}
