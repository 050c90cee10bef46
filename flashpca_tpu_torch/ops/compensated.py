"""Compensated (two-float) products for float64-grade results from
float32 arithmetic.

The reference computes its accuracy check in float64 end to end
(randompca.cpp:684-697) and promises ``mse < 1e-8``.  A plain float32
gram product carries ~1e3*eps relative noise from accumulating
~1e5-long contractions, which alone floors the check near 2e-8 at
biobank scale.  This module removes that noise with error-free
transformations:

* ``twosum``  : Knuth branch-free TwoSum -- a + b as (sum, exact error).
* ``twoprod`` : Dekker split product -- a * b as (prod, exact error),
  with the split constant of the operand's dtype.
* genotype values enter as an EXACT two-float split of the float64
  standardized value (per-SNP table over the 2-bit code), hi + lo ==
  the float64 value to ~2^-49 relative.
* long contractions are chunked; chunk partials are ordinary float32
  products whose results combine with TwoSum, so the accumulated error
  stays ~eps of the final value.

Every function here is plain PyTorch (elementwise ops and small
matmuls; no fused kernels, no fast-math: TwoSum and Dekker need IEEE
rounding).  The data-pass engine for CUDA operators is the pair of
hand-written kernels B3/B4 (kernels/packed_matvec.py); ``gram_ff_p``
below is the blocked PyTorch path the CPU operators use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.plink import CODE_TO_DOSAGE, PACK_DENSITY
from ..utils.device import host64
from .standardize import _inv_sd

# Dekker split constants: 2^ceil(t/2) + 1 splits a t-bit significand
# into halves whose pairwise products are exact -- 2^12+1 for float32
# (t=24), 2^27+1 for float64 (t=53).  The float32 constant on float64
# inputs would silently break the "e exact" contract.
_SPLIT32 = 4097.0
_SPLIT64 = 134217729.0

FF_CHUNK = 2048


# ---------------------------------------------------------------------------
# Error-free transformations (elementwise)
# ---------------------------------------------------------------------------

def twosum(a, b):
    """Knuth TwoSum: s = fl(a+b), e exact with a + b == s + e."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    const = _SPLIT64 if a.dtype == torch.float64 else _SPLIT32
    c = a * const
    hi = c - (c - a)
    return hi, a - hi


def twoprod(a, b):
    """Dekker TwoProd: p = fl(a*b), e exact with a * b == p + e."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sum_ff(parts):
    """Compensated reduction of ``parts`` (C, ...) over dim 0: returns
    (hi, lo) with hi + lo ~= the exact sum.  Pairwise TwoSum tree; each
    level's exact errors accumulate into lo with a plain add (they are
    eps-sized relative to the partials)."""
    err = torch.zeros(parts.shape[1:], dtype=parts.dtype, device=parts.device)
    if parts.shape[0] == 0:
        return err, err
    while parts.shape[0] > 1:
        if parts.shape[0] % 2:
            parts = torch.cat([parts, torch.zeros_like(parts[:1])])
        s, e = twosum(parts[0::2], parts[1::2])
        err = err + e.sum(dim=0)
        parts = s
    return parts[0], err


def split_f64(x):
    """Host split of float64 values into float32 (hi, lo) with
    hi + lo == x to ~2^-49 relative."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def default_chunk() -> int:
    """Contraction chunk length for the compensated matmuls: within a
    chunk the float32 partial accumulates uncompensated (a few eps at
    2048); across chunks TwoSum is exact."""
    return FF_CHUNK


def _pad_axis(A, axis: int, mult: int):
    """Zero-pad ``axis`` to a multiple of ``mult`` (zeros are exact
    no-ops for every contraction here)."""
    pad = (-A.shape[axis]) % mult
    if not pad:
        return A
    shape = list(A.shape)
    shape[axis] = pad
    return torch.cat([A, torch.zeros(shape, dtype=A.dtype, device=A.device)],
                     dim=axis)


# ---------------------------------------------------------------------------
# Chunk-compensated matmuls
# ---------------------------------------------------------------------------

def matdot_ff(A, B, *, chunk: int | None = None):
    """(hi, lo) of A^T B, the (long) leading contraction axis split into
    ``chunk``-sized pieces whose partials combine with TwoSum."""
    chunk = chunk or default_chunk()
    A = _pad_axis(A, 0, chunk)
    B = _pad_axis(B, 0, chunk)
    n, ka = A.shape
    kb = B.shape[1]
    C = n // chunk
    parts = torch.einsum("cna,cnb->cab", A.reshape(C, chunk, ka),
                         B.reshape(C, chunk, kb))
    return sum_ff(parts)


def rowdot_ff(W, X2, *, chunk: int | None = None):
    """(hi, lo) of W @ X2 for W (m, n), X2 (n, k): the contraction axis
    n is chunked, partials TwoSum-combined."""
    chunk = chunk or default_chunk()
    W = _pad_axis(W, 1, chunk)
    X2 = _pad_axis(X2, 0, chunk)
    m, n = W.shape
    k = X2.shape[1]
    C = n // chunk
    parts = torch.einsum("mcn,cnk->cmk", W.reshape(m, C, chunk),
                         X2.reshape(C, chunk, k))
    return sum_ff(parts)


# ---------------------------------------------------------------------------
# Exact two-float genotype lookup tables
# ---------------------------------------------------------------------------

def code_value_luts(mean, sd, p_pad: int | None = None):
    """(p_pad, 4) float32 hi/lo host tables of the EXACT float64
    standardized value per 2-bit code: value[c] = (dosage_c - mean)/sd
    for non-missing codes, 0 for the NA code and for sd <= VAR_TOL
    columns (scaled_geno_lookup semantics, data.cpp:299-320).  Rows past
    the true SNP count are zero."""
    mean = np.asarray(mean, dtype=np.float64)
    sd = np.asarray(sd, dtype=np.float64)
    inv = _inv_sd(sd)
    mean = np.where(inv > 0.0, mean, 0.0)
    p = mean.shape[0]
    vals = (CODE_TO_DOSAGE[None, :] - mean[:, None]) * inv[:, None]
    vals[:, 1] = 0.0  # NA code
    if p_pad is None:
        p_pad = p
    out = np.zeros((p_pad, 4), dtype=np.float64)
    out[:p] = vals
    return split_f64(out)


def decode_lut(packed, lut, dtype=torch.float32):
    """Packed (m, nbytes) uint8 -> (m, n4) values in permuted sample
    order via an EXACT per-code lookup (no arithmetic on the table
    values, so eps-level lo tables survive the decode bit for bit)."""
    segs = []
    l0, l1, l2, l3 = (lut[:, c].to(dtype)[:, None] for c in range(4))
    for s in range(PACK_DENSITY):
        c = (packed >> (2 * s)) & 3
        segs.append(torch.where(c == 0, l0,
                                torch.where(c == 1, l1,
                                            torch.where(c == 2, l2, l3))))
    return torch.cat(segs, dim=1)


# ---------------------------------------------------------------------------
# Compensated gram product (wide operator, permuted space)
# ---------------------------------------------------------------------------

def gram_ff_block(packed, lut_hi, lut_lo, xp, carry, *,
                  chunk: int | None = None):
    """One SNP block of y += W^T W xp in two-float arithmetic.

    ``carry`` is the (y_hi, y_err) pair; returns the updated pair.
    W = W_hi + W_lo is the exact standardized block (decode_lut)."""
    y_hi, y_err = carry
    Wh = decode_lut(packed, lut_hi, xp.dtype)
    Wl = decode_lut(packed, lut_lo, xp.dtype)
    # stage 1: z = W xp, contraction over samples (the long axis)
    zh, zl = rowdot_ff(Wh, xp, chunk=chunk)
    zl = zl + Wl @ xp                           # eps-level correction
    # stage 2: t = W^T z, contraction over this block's SNPs (short)
    t = Wh.T @ zh
    y_hi, e = twosum(y_hi, t)
    y_err = y_err + e + Wh.T @ zl + Wl.T @ zh
    return y_hi, y_err


def gram_ff_p(packed, lut_hi, lut_lo, xp, *, block_size: int,
              chunk: int | None = None):
    """(y_hi, y_lo) of W^T W xp over all SNP blocks (permuted space).
    The caller masks byte-padding positions on input and output."""
    carry = (torch.zeros_like(xp), torch.zeros_like(xp))
    for s in range(0, packed.shape[0], block_size):
        carry = gram_ff_block(packed[s: s + block_size],
                              lut_hi[s: s + block_size],
                              lut_lo[s: s + block_size], xp, carry,
                              chunk=chunk)
    return carry


# ---------------------------------------------------------------------------
# Compensated Rayleigh-Ritz / residual reductions (float64 host results)
# ---------------------------------------------------------------------------

def ritz_ff(U, y_hi, y_lo):
    """float64 host Gram G = U^T (A U) from a two-float product pair,
    with the long reduction chunk-compensated (a plain float32 U^T y at
    N ~ 5e5 re-adds the very noise the ff product removed)."""
    g_hi, g_lo = matdot_ff(U, y_hi)
    g_lo = g_lo + U.T @ y_lo
    g = host64(torch.stack([g_hi, g_lo]))
    return g[0] + g[1]


def residual_sums_ff(y_hi, y_lo, U, dd):
    """(K,) per-component sums of squared residual
    ``(A U)_ik - U_ik * dd_k`` with the subtraction in two-float
    arithmetic (dd = eigenvalue * divisor, float64, split on the host).
    Returns float64 host values."""
    dd_hi, dd_lo = split_f64(dd)
    dh = torch.as_tensor(dd_hi, device=U.device).to(U.dtype)[None, :]
    dl = torch.as_tensor(dd_lo, device=U.device).to(U.dtype)[None, :]
    p, pe = twoprod(U, dh)
    s, se = twosum(y_hi, -p)
    r = s + (y_lo - pe - U * dl + se)
    chunk = default_chunk()
    r = _pad_axis(r, 0, chunk)
    n, k = r.shape
    parts = (r * r).reshape(n // chunk, chunk, k).sum(dim=1)
    e_hi, e_lo = sum_ff(parts)
    return host64(e_hi + e_lo)


def gram_small_ff(B):
    """float64 host Gram M = B^T B with the long reduction
    chunk-compensated (the metric of the generalized Rayleigh-Ritz in
    polish_subspace)."""
    m = host64(torch.stack(matdot_ff(B, B)))
    M = m[0] + m[1]
    return 0.5 * (M + M.T)
