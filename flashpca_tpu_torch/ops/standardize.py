"""Column standardization of dense matrices, matching the reference exactly.

Five methods (reference: util.h:34-38, util.cpp:24-192):

* ``none``   (0): impute NaN -> column mean; no scaling. Returned sd is 1.
* ``sd``     (1): (x - mean)/sd with the (n-1)-denominator sd over
  non-missing values; NaN -> 0; columns with sd <= VAR_TOL are set to
  their mean.
* ``binom``  (2): mean = 2*p_hat, sd = sqrt(p_hat(1-p_hat)) ("old
  Eigenstrat", Price 2006 eqn 3).
* ``binom2`` (3): sd = sqrt(2*p_hat*(1-p_hat)).
* ``center`` (4): x - mean; NaN -> 0. Returned sd is 1.

Statistics are computed over non-missing entries only; imputation of a
missing entry is to the mean (which is 0 after centering/scaling).

Runs in numpy float64 on the host: the stats must be exact regardless of
the device compute dtype, and this is a one-shot O(np) pass.
"""

from __future__ import annotations

import numpy as np

VAR_TOL = 1e-9  # reference: util.h:33

STAND_NONE = "none"
STAND_SD = "sd"
STAND_BINOM = "binom"
STAND_BINOM2 = "binom2"
STAND_CENTER = "center"

_METHODS = (STAND_NONE, STAND_SD, STAND_BINOM, STAND_BINOM2, STAND_CENTER)

# CLI/R integer codes (reference: util.h:34-38, flashpcaR/R/flashpca.R:148-155)
METHOD_CODES = {"none": 0, "sd": 1, "binom": 2, "binom2": 3, "center": 4}


def standardize(
    X: np.ndarray, method: str = "binom2"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standardize columns of X.

    Returns ``(X_std, mean, sd)`` where X_std is a new float64 array and
    mean/sd are the per-column statistics (sd is all-ones for methods
    that don't scale), matching ``standardise`` (reference: util.cpp:24-192)
    and the R oracle ``scale2`` (flashpcaR/R/scale2.R:21-41).
    """
    if method not in _METHODS:
        raise ValueError(f"unknown standardization method: {method}")
    X = np.array(X, dtype=np.float64, copy=True)
    if X.ndim != 2:
        raise ValueError("X must be 2-D")
    n, p = X.shape
    na = np.isnan(X)
    ngood = n - na.sum(axis=0)
    if np.any(ngood == 0):
        raise ValueError("column with all values missing")
    total = np.where(na, 0.0, X).sum(axis=0)
    mean = total / ngood
    sd = np.ones(p, dtype=np.float64)

    if method == STAND_NONE:
        X[na] = np.broadcast_to(mean, X.shape)[na]
        return X, mean, sd

    if method == STAND_CENTER:
        X = X - mean
        X[na] = 0.0
        return X, mean, sd

    # degenerate columns (single observation, non-genotype values with
    # p_hat outside [0, 1]) produce NaN/inf sd exactly like both
    # references, which are SILENT about it -- suppress the numpy
    # warnings so np.seterr(all='raise') callers match
    with np.errstate(divide="ignore", invalid="ignore"):
        if method == STAND_SD:
            # shifted-data variance with K=1 and (n-1) denominator over
            # non-missing entries (reference: util.cpp:75-95)
            shifted = np.where(na, 0.0, X - 1.0)
            ssum = shifted.sum(axis=0)
            ssum_sqr = (shifted * shifted).sum(axis=0)
            var = (ssum_sqr - (ssum * ssum) / ngood) / (ngood - 1)
            sd = np.sqrt(var)
        else:  # binom / binom2
            p_hat = mean / 2.0
            mult = 1.0 if method == STAND_BINOM else 2.0
            sd = np.sqrt(mult * p_hat * (1.0 - p_hat))

    scaled = np.where(sd > VAR_TOL, (X - mean) / np.where(sd > VAR_TOL, sd, 1.0),
                      np.broadcast_to(mean, X.shape))
    scaled[na] = 0.0
    return scaled, mean, sd


def standardize_transpose(
    W: np.ndarray, method: str = "binom2"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standardize the ROWS of a (p, N) variable-major matrix.

    The role of ``standardise_transpose`` (reference: util.cpp:195-268)
    for data stored SNP-major -- implemented as the COLUMN standardizer
    applied to W^T, which is deliberately MORE robust than the
    reference's transpose variant: util.cpp:195-268 has no NaN handling
    (one missing value poisons its whole row), leaves rows at
    sd <= VAR_TOL as raw values (no set-to-mean fallback), and rejects
    method 'none'; here every method behaves identically to
    :func:`standardize` (a divergence, documented rather
    than reproduced).  Returns ``(W_std, mean, sd)`` with per-row
    statistics.
    """
    Xs, mean, sd = standardize(np.asarray(W).T, method)
    return np.ascontiguousarray(Xs.T), mean, sd


def scale2(X: np.ndarray, type: str = "2",
           impute: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """R-package ``scale2`` equivalent, implemented FAITHFULLY to the R
    oracle (flashpcaR/R/scale2.R:21-41): type "1" = binom, type "2" =
    binom2; returns (scaled, center, scale).

    Deliberately NOT a delegate to :func:`standardize`: the R oracle
    has no VAR_TOL -- a zero-variance column divides 0/0 to NaN and
    ``impute`` maps it to 0, where the C++ ``standardise`` (and so
    ``standardize``) sets such columns to their MEAN (util.cpp's
    ``else X(i,j) = mean(j)``).  The two references disagree on
    monomorphic SNPs; each wrapper follows its own.  Away
    from zero variance the outputs are bit-identical.  Invalid types
    raise like R's ``match.arg``."""
    if str(type) not in ("1", "2"):
        raise ValueError(f"type must be '1' or '2', got {type!r}")
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError("X must be 2-D")
    mult = 1.0 if str(type) == "1" else 2.0
    na = np.isnan(X)
    sum2 = X.shape[0] - na.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(na, 0.0, X).sum(axis=0) / (2.0 * sum2)
        xsd = np.sqrt(mult * p * (1.0 - p))
        s = (X - 2.0 * p[None, :]) / xsd[None, :]
    if impute:
        s[np.isnan(s)] = 0.0
    return s, 2.0 * p, xsd


def _safe_mean_inv(mean: np.ndarray, sd: np.ndarray):
    """(mean zeroed where the column is zeroed, 1/sd with the VAR_TOL
    rule) -- the PAIRED decode constants.  One helper so the guard can
    never desynchronize between lookup_tables (what the kernels decode)
    and sumsq_from_moments (the analytic trace): an all-missing SNP has
    NaN stats, and a NaN mean reaching the factored-cubic coefficients
    poisons every product via 0 * NaN (reproduced)."""
    inv = _inv_sd(sd)
    return np.where(inv > 0.0, mean, 0.0), inv


def _inv_sd(sd: np.ndarray) -> np.ndarray:
    """1/sd with columns at sd <= VAR_TOL zeroed -- THE definition of
    which columns the decode kernels zero.  Shared by lookup_tables and
    sumsq_from_moments so the analytic sum of squares can never
    desynchronize from what the kernels actually decode."""
    return np.where(sd > VAR_TOL, 1.0 / np.where(sd > VAR_TOL, sd, 1.0), 0.0)


def lookup_tables(
    mean: np.ndarray, sd: np.ndarray, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Per-SNP decode constants (offset, inv_sd) for the packed operator.

    The streaming reference caches 4 standardized values per SNP
    (``scaled_geno_lookup``, data.cpp:316-320); we instead carry
    ``inv_sd = 1/sd`` (0 where sd <= VAR_TOL, zeroing the column exactly
    like the reference's zero-initialized lookup) and the mean, and
    reconstruct ``(dosage - mean) * inv_sd`` in the decode kernel.
    """
    mean = np.asarray(mean, dtype=np.float64)
    sd = np.asarray(sd, dtype=np.float64)
    # the reference divides by zero the same way for all-missing SNPs
    # (data.cpp:262-291); see _safe_mean_inv for why the mean must be
    # forced finite here
    mean, inv = _safe_mean_inv(mean, sd)
    return mean.astype(dtype), inv.astype(dtype)


def sumsq_from_moments(
    ngood: np.ndarray,
    dsum: np.ndarray,
    d2sum: np.ndarray,
    mean: np.ndarray,
    sd: np.ndarray,
) -> np.ndarray:
    """Exact per-SNP sum of squared STANDARDIZED genotypes, float64.

    Missing entries decode to exactly 0 (the decode kernels' contract),
    so over the non-missing dosages g:

        sum((g - mean)^2) * inv^2
          = (d2sum - 2*mean*dsum + ngood*mean^2) * inv^2

    with ``inv = 1/sd`` zeroed below VAR_TOL exactly like
    :func:`lookup_tables`.  Works for ANY (mean, sd) pair -- empirical
    stats or preloaded meansd/MAF-file values (projection mode); a
    zeroed column's mean is forced finite first (also like
    lookup_tables), because an all-missing SNP has NaN stats and
    ``inv * inv * NaN`` is NaN, not 0 -- without the guard one such
    SNP would poison the whole trace/pve sum.

    This replaces a whole decode pass over the data: the reference
    accumulates trace(X X^T) during its first streamed operator pass
    (svdwide.cpp:44-45); here the trace and UCCA's per-SNP variances
    are free byproducts of the host stats pass."""
    ngood = np.asarray(ngood, dtype=np.float64)
    dsum = np.asarray(dsum, dtype=np.float64)
    d2sum = np.asarray(d2sum, dtype=np.float64)
    mean = np.asarray(mean, dtype=np.float64)
    sd = np.asarray(sd, dtype=np.float64)
    mean, inv = _safe_mean_inv(mean, sd)
    ss = d2sum - 2.0 * mean * dsum + ngood * mean * mean
    # ss is a sum of squares; cancellation can leave a tiny negative
    return inv * inv * np.maximum(ss, 0.0)
