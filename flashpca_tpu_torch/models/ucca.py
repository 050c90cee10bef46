"""UCCA: per-SNP multivariate ANOVA (like plink.multivariate).

Equivalent of ``RandomPCA::ucca`` (reference: randompca.cpp:532-625)
and ``wilks`` (randompca.cpp:103-119): for each SNP j, the F-test of
``lm(SNP_j ~ Y)``:

* thin SVD of standardized Y once: Y = U S V^T
* ``r2_j = | sum(((cov(x_j, Y) V sqrt(n-1)) / S)^2) / var(x_j) |``
* ``F = r2/(1-r2) * (n-k-1)/k``, ``p = SF_F(F; k, n-k-1)``

Result columns: [R, Fstat, P] with R = sqrt(r2).

On the packed path the per-SNP covariances and sums are one
``crossprod`` pass of the k + 1 columns ``[Y_c, 1]`` (kernel B1 on a
float32 CUDA operator, resident or streamed from the host; the
functional core at float64); the variances come from the per-SNP sums
of squares of the stats pass.  On a :class:`DenseOperator` the same
crossprod is one ``torch.matmul`` and the variances come from its
row-chunked sums of squares; an (N, p) matrix is standardized on the
host in float64 and held by such an operator (float64 unless ``dtype``
says otherwise) on the requested device.  The k x k SVD and the F statistics run
on the host in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.stats import f as f_dist

from ..io.plink import PlinkDataset
from ..ops.operator import (TALL_OPERATORS, WIDE_OPERATORS,
                            build_packed_operator, check_operator_conflicts)
from ..ops.standardize import standardize
from ..utils.device import host64
from ._common import matrix_operator


@dataclass
class UccaResult:
    result: np.ndarray  # (p, 3): R, Fstat, P
    npheno: int = 0     # (flashpcaR ucca.R:171)
    nsnps: int = 0

    @property
    def r(self):
        return self.result[:, 0]

    @property
    def fstat(self):
        return self.result[:, 1]

    @property
    def pval(self):
        return self.result[:, 2]


def wilks(r2: np.ndarray, n: int, k: int) -> np.ndarray:
    """(R, F, p) per SNP from r^2 (randompca.cpp:103-119)."""
    r2 = np.asarray(r2, dtype=np.float64)
    lam = 1.0 - r2
    F = (1.0 - lam) / lam * (n - k - 1) / k
    pval = f_dist.sf(F, k, n - k - 1)
    return np.column_stack([np.sqrt(r2), F, pval])


def _r2_from_moments(covXY, varx, sv, Vy, n):
    s = (covXY @ Vy) * np.sqrt(n - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        # constant SNPs (varx == 0) yield nan, like the reference's 0/0
        return np.abs(((s / sv[None, :]) ** 2).sum(axis=1) / varx)


def ucca(
    data,
    Y: np.ndarray,
    *,
    stand_x: str | None = None,
    stand_y: str = "sd",
    block_size: int | None = None,
    dtype=None,
    device=None,
    mesh=None,
    streaming: bool | str = "auto",
    memory_mb: int | None = None,
) -> UccaResult:
    """Per-SNP CCA of ``data`` (PLINK root / dataset, a prebuilt
    :class:`PackedOperator` / :class:`StreamingPackedOperator` /
    :class:`DenseOperator`, or an (N, p) matrix) against the (N, k)
    phenotype matrix Y.

    ``streaming`` bounds device memory via the host-streaming operator
    (the reference's online UCCA, randompca.cpp:578-625); 'auto' streams
    when the packed data exceeds 0.7 x the card's memory.  ``device``
    defaults to ``cuda`` and raises without a GPU; ``device="cpu"`` runs
    the PyTorch path (float64 by default).  ``mesh`` shards the packed
    operator (parallel/dist.py): its one crossprod's SNP rows are
    gathered."""
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    Y_std, _, _ = standardize(Y, stand_y)
    n, k = Y_std.shape

    # thin SVD of Y (randompca.cpp:542,591)
    _, sv, Vt = np.linalg.svd(Y_std, full_matrices=False)
    Vy = Vt.T

    if isinstance(data, str):
        data = PlinkDataset.open(data)
    if isinstance(data, TALL_OPERATORS):
        raise ValueError(
            "ucca() needs the wide product layout (X^T Y crossprod); "
            "pass the PLINK data (or a wide operator) instead of a "
            "tall operator")
    prebuilt = isinstance(data, WIDE_OPERATORS)
    matrix = not prebuilt and not isinstance(data, PlinkDataset)
    if matrix and hasattr(data, "crossprod"):
        raise TypeError(
            f"ucca() got a {type(data).__module__}.{type(data).__name__}, "
            "which is not an operator of this package; build a "
            "flashpca_tpu_torch operator (e.g. DenseOperator) instead")
    if prebuilt and stand_x is not None:
        raise ValueError(
            "stand_x= was passed with a prebuilt operator, whose "
            "standardization is baked in; rebuild the operator with "
            "the desired stats")
    stand_x = stand_x or "binom2"
    if matrix:
        op = matrix_operator(data, stand_x, dtype, device, mesh=mesh,
                             who="UCCA")
    elif prebuilt:
        check_operator_conflicts(data, dtype=dtype, streaming=streaming,
                                 memory_mb=memory_mb, block_size=block_size,
                                 device=device, mesh=mesh)
        op = data
    else:
        if data.n_samples != n:
            # fail BEFORE the full-file stats pass and device upload
            raise ValueError("Y rows must equal the number of samples")
        # with_sumsq: the per-SNP variances below become an analytic
        # byproduct of the stats pass instead of a decode pass
        mean, sd, sumsq = data.snp_stats(stand_x, with_sumsq=True)
        op = build_packed_operator(
            data, mean, sd, streaming=streaming, memory_mb=memory_mb,
            block_size=block_size, dtype=dtype, device=device, mesh=mesh,
            snp_sumsq=sumsq)
    if op.n_samples != n:
        raise ValueError("Y rows must equal the number of samples")
    Yc = Y_std - Y_std.mean(axis=0, keepdims=True)
    # cov(x_j, Y) = x_j^T Yc / (n-1): Yc columns sum to zero, so the
    # x-mean correction vanishes.  The all-ones column (the per-SNP sums)
    # rides the SAME pass: the kernels are decode-bound, so an extra
    # panel column is nearly free, and a second pass would double the
    # host-to-device traffic when streaming
    both = np.concatenate([Yc, np.ones((n, 1))], axis=1)
    out = host64(op.crossprod(both))
    covXY = out[:, :k] / (n - 1.0)
    xsum = out[:, k]
    # var(x_j) of the standardized column (not exactly 1 with missing)
    xsumsq = op.snp_sumsq
    varx = (xsumsq - xsum * xsum / n) / (n - 1.0)

    r2 = _r2_from_moments(covXY, varx, sv, Vy, n)
    res = wilks(r2, n, k)
    return UccaResult(result=res, npheno=k, nsnps=res.shape[0])
