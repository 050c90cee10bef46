"""Packed genotypes resident on the card, and the program's operator on
them.

The configuration's cohort is generated on the device from the seed
(gen.py).  The operator is ``PackedOperator`` (the wide gram X X^T) or
``TallPackedOperator`` (the tall gram X^T X), as the configuration's
``operator_mode`` picks it (``auto``: tall when n > 2p, as ``pca()``
picks it for a fileset).  ``check()`` verifies the wide decomposition:
on the tall path it runs through a wide operator on the same bytes
(not a copy).  The reference's products read the same bytes
(reference.py).
"""

from __future__ import annotations

import torch

from portbench import gen, reference

# the operators' products the benchmark wraps: method -> (group,
# products, dots a genotype and column in all, output halves, rows read,
# rows written).  A plain product X v or X^T x does one multiply-add a
# genotype and column; a gram is two products; the two-float grams count
# their dots as the kernel table does: the wide one B3 (two) and B4
# (three), the tall one B5 (two), B3 (two) and B1 on the low half (one).
# "space" is the solver's: n4 permuted samples wide, p SNPs tall.
PRODUCTS = {
    "gram_permuted": ("plain", 2, 2, 1, "space", "space"),
    "gram_ff_permuted": ("ff", 2, 5, 2, "space", "space"),
    "crossprod": ("plain", 1, 1, 1, "n", "p"),
    "prod": ("plain", 1, 1, 1, "p", "n"),
    "_cross_p": ("narrow", 1, 1, 1, "n", "p"),
    "_mv_p": ("narrow", 1, 1, 1, "p", "n"),
}


class Cohort:
    """The genotypes of a configuration, generated on ``device`` from
    ``seed``, the program's operators on them, and the float64
    reference's products on the same bytes."""

    products = PRODUCTS

    def __init__(self, config: dict, seed: int, device, cpu_kernels=False):
        from flashpca_tpu_torch import PackedOperator, TallPackedOperator
        from flashpca_tpu_torch.io.plink import stats_from_moments
        from flashpca_tpu_torch.ops.standardize import sumsq_from_moments

        n, p = config["n_samples"], config["n_snps"]
        self.n, self.p = n, p
        self.pops = config["structure"]["pops"]
        mode = config["operator_mode"]
        self.tall = mode == "tall" or (mode == "auto" and n > 2 * p)
        # the seed orders the axis the gram sums over (gen.py)
        drawn = gen.generate(n, p, seed, config["structure"], device,
                             axis="samples" if self.tall else "snps")
        self.packed = drawn.packed
        self.snp_index, self.sample_index = drawn.snp_index, \
            drawn.sample_index
        ngood, dsum, d2sum = gen.moments(self.packed, n)
        mean, sd = stats_from_moments(ngood, dsum, "binom2")
        sumsq = sumsq_from_moments(ngood, dsum, d2sum, mean, sd)
        # the CPU has no kernels: their plain versions run the same path
        kw = dict(device=device, snp_sumsq=sumsq)
        if cpu_kernels:
            kw.update(dtype=torch.float32, use_kernels=True)
        cls = TallPackedOperator if self.tall else PackedOperator
        self.op = cls(self.packed, mean, sd, n, **kw)
        self.wide = (PackedOperator(self.packed, mean, sd, n, **kw)
                     if self.tall else self.op)

    @property
    def device(self):
        return self.packed.device

    def operators(self) -> list:
        """The program's distinct operators, each wrapped once."""
        return list({id(o): o for o in (self.op, self.wide)}.values())

    def free_program(self) -> None:
        """Drop the program's operators; the bytes stay for the
        reference."""
        self.op = self.wide = None

    # -- the float64 reference on the same bytes ----------------------------
    def _stats(self):
        return reference.binom2_stats(self.packed, self.n)

    def gram_columns(self, U: torch.Tensor) -> torch.Tensor:
        """X X^T U, float64, for an (n, m) float64 panel on the device."""
        return reference.gram_columns(self.packed, self.n, *self._stats(), U)

    def cross_and_prod(self, Yv: torch.Tensor, U: torch.Tensor):
        """(X^T Yv, X U), float64, in one decode pass."""
        return reference.cross_and_prod(self.packed, self.n, *self._stats(),
                                        Yv, U)

    def rows_product(self, idx, w: torch.Tensor) -> torch.Tensor:
        """X[:, idx] w, float64."""
        return reference.rows_product(self.packed, self.n, *self._stats(),
                                      idx, w)

    def scca(self, Y: torch.Tensor, V0: torch.Tensor, lam1: float,
             lam2: float, maxiter: int, tol: float, **kw):
        """The reference's own sparse CCA of X against ``Y``."""
        return reference.scca(self.packed, self.n, *self._stats(), Y, V0,
                              lam1, lam2, maxiter, tol, **kw)
