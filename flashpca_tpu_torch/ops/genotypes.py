"""Packed-genotype decode and the permuted sample space, in PyTorch.

The genotype matrix lives in device memory as the raw PLINK 2-bit
bytes, SNP-major ``(p, nbytes)`` uint8 -- 16x smaller than float32.
Decoding to standardized floats happens on the fly inside the blocked
products (ops/operator.py) and inside the CUDA kernels
(kernels/csrc/).

Sample-deinterleave permutation
-------------------------------
Byte ``b`` packs samples ``4b .. 4b+3`` at bit positions ``2s``.  The
operators work on vectors in "permuted space" of length
``n4 = 4*nbytes`` where position ``s*nbytes + b`` holds original sample
``4b + s``.  Segment ``s`` of a permuted vector then lines up with the
2-bit plane ``(byte >> 2s) & 3``, so decode is four independent
shift-mask-scale passes.  Permuting in and out is an O(N) reshape at
the operator boundary.

Standardization uses per-SNP ``(mean, inv_sd)``: a code decodes to
``(dosage - mean) * inv_sd`` for non-missing, 0 for missing, and
``inv_sd = 0`` zeroes near-constant columns (the reference's
``scaled_geno_lookup`` semantics, data.cpp:299-320).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.plink import CODE_IS_NA, CODE_TO_DOSAGE, PACK_DENSITY


# -- permutation --------------------------------------------------------------

def permute_samples(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(N, k) sample-space -> (n4, k) permuted space (zero-padded)."""
    n4 = nbytes * PACK_DENSITY
    x2 = x if x.ndim == 2 else x[:, None]
    pad = n4 - x2.shape[0]
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad))
    out = x2.reshape(nbytes, PACK_DENSITY, x2.shape[1]).transpose(0, 1)
    out = out.reshape(n4, x2.shape[1])
    return out if x.ndim == 2 else out[:, 0]


def permute_samples_np(x: np.ndarray, nbytes: int) -> np.ndarray:
    """Host numpy twin of :func:`permute_samples` (solver start panels
    are drawn and permuted on the host)."""
    n4 = nbytes * PACK_DENSITY
    x2 = np.asarray(x)
    vec = x2.ndim == 1
    if vec:
        x2 = x2[:, None]
    pad = n4 - x2.shape[0]
    if pad:
        x2 = np.pad(x2, ((0, pad), (0, 0)))
    out = x2.reshape(nbytes, PACK_DENSITY, x2.shape[1]).transpose(1, 0, 2)
    out = out.reshape(n4, x2.shape[1])
    return out[:, 0] if vec else out


def unpermute_samples(y: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(n4, k) permuted space -> (N, k) sample space (padding dropped)."""
    y2 = y if y.ndim == 2 else y[:, None]
    n4, k = y2.shape
    nbytes = n4 // PACK_DENSITY
    out = y2.reshape(PACK_DENSITY, nbytes, k).transpose(0, 1).reshape(n4, k)
    out = out[:n_samples]
    return out if y.ndim == 2 else out[:, 0]


def valid_mask_permuted(n_samples: int, nbytes: int, dtype,
                        device=None) -> torch.Tensor:
    """(n4,) 1.0 at positions holding a real sample, 0.0 at byte padding."""
    mask = np.zeros(nbytes * PACK_DENSITY, dtype=np.float64)
    mask[:n_samples] = 1.0
    perm = mask.reshape(nbytes, PACK_DENSITY).T.reshape(-1)
    return torch.as_tensor(perm, dtype=dtype, device=device)


# -- decode ---------------------------------------------------------------------

def decode_standardized(packed: torch.Tensor, mean: torch.Tensor,
                        invsd: torch.Tensor, dtype) -> torch.Tensor:
    """Packed (m, nbytes) uint8 -> standardized (m, n4) floats, permuted
    sample order.  Missing (code 1) -> 0; inv_sd == 0 zeroes the row."""
    segs = []
    mu = mean.to(dtype)[:, None]
    iv = invsd.to(dtype)[:, None]
    for s in range(PACK_DENSITY):
        ci = ((packed >> (2 * s)) & 3).to(torch.int32)
        dosage = (2 - (ci & 1) - ((ci >> 1) & 1)).to(dtype)
        notna = (ci != 1).to(dtype)
        segs.append((dosage - mu) * iv * notna)
    return torch.cat(segs, dim=1)


# -- numpy oracle (tests / host fallbacks) ------------------------------------

def dense_standardized_np(codes: np.ndarray, mean: np.ndarray,
                          sd: np.ndarray, dtype=np.float64) -> np.ndarray:
    """(p, N) standardized matrix from 2-bit codes (sd <= VAR_TOL zeroes
    the row; NA -> 0)."""
    from .standardize import _inv_sd

    inv = _inv_sd(sd)
    dosage = CODE_TO_DOSAGE[codes]
    W = (dosage - mean[:, None]) * inv[:, None]
    W[CODE_IS_NA[codes]] = 0.0
    return W.astype(dtype)
