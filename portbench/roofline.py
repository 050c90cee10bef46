"""The least time a product can take on one H100, from its shapes.

Copied from the bound arithmetic of ``chip_smoke.py`` (its
``PEAK_FP32_FLOPS``/``PEAK_BYTES_S`` at lines 284-285 and PERF.md's
kernel table: 2 * dots * kc * p * n operations, the packed bytes once)
when the copy was taken, and extended to whole operator products so that
the count does not depend on which kernels implement them.  What each
product counts is the cohort's table (``cohorts/*.py``).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, 67
TFLOP/s float32 on the CUDA cores (full-float32 products; TF32 would
break the accuracy contract) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FLOAT32_BYTES = 4


def packed_bytes(n_samples: int, n_snps: int) -> int:
    """Bytes of the packed genotypes: four samples a byte, a row a SNP."""
    return n_snps * ((n_samples + 3) // 4)


def product_work(n_samples: int, n_snps: int, kc: int, products: int,
                 dots: int, halves: int, in_rows: int, out_rows: int):
    """(operations, bytes) that one call of an operator product needs.

    ``kc`` is the panel width the caller passed (not a padded width);
    ``products`` the passes over the genotypes (a gram two), ``dots``
    the multiply-adds a genotype and column in all, ``halves`` the
    output's (two for a two-float result), as a cohort's table gives
    them; ``in_rows``/``out_rows`` are the lengths of the panel read and
    of the panel written.  The packed bytes count once a product; each
    panel is read once and written once."""
    flops = 2.0 * dots * kc * n_snps * n_samples
    nbytes = (products * packed_bytes(n_samples, n_snps)
              + FLOAT32_BYTES * kc * (in_rows + halves * out_rows))
    return flops, nbytes


def least_seconds(flops: float, nbytes: float):
    """(least seconds, "ops" or "bytes": which peak bounds them)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
