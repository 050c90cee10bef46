"""Projection of new samples onto existing SNP loadings.

Equivalent of ``RandomPCA::project`` (reference: randompca.cpp:745-820)
and the R ``project()`` (flashpcaR/R/project.R:54-164):

``Px[:, i] = X V[:, i] / sqrt(div)`` where X is standardized with the
*stored* per-SNP mean/sd (from a meansd file/array or converted from
MAF), and ``div`` defaults to the number of SNPs.

MAF conversion quirk preserved exactly: ``mean = 2*maf`` and the sd
slot holds the binom2 *variance* ``2*maf*(1-maf)``, not its square root
(randompca.cpp:745-751).

On the packed path the product is one ``prod`` pass of the operator:
kernel B2 (y = X v) on a float32 CUDA operator, resident or streamed
from the host, and the functional core at float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.plink import PlinkDataset
from ..io.text import maf2meansd
from ..ops.operator import build_packed_operator
from ..ops.standardize import _inv_sd
from ..utils.device import host64
from ._common import resolve_divisor as _resolve_div


@dataclass
class ProjectResult:
    projection: np.ndarray  # (N, k)


def _project_operator(op, V, div: float) -> np.ndarray:
    """``X V / sqrt(div)`` on a packed operator (one ``prod`` pass), as a
    float64 host array; ``V`` is the (p, k) loadings."""
    return host64(op.prod(V)) / np.sqrt(div)


def project(
    data,
    loadings: np.ndarray,
    *,
    meansd: np.ndarray | None = None,
    maf: np.ndarray | None = None,
    orig_mean: np.ndarray | None = None,
    orig_sd: np.ndarray | None = None,
    divisor: str = "p",
    stand: str = "binom2",
    block_size: int | None = None,
    dtype=None,
    device=None,
    mesh=None,
    ref_alleles: list | None = None,
    snp_ids: list | None = None,
    check_geno: bool = True,
    streaming: bool | str = "auto",
    memory_mb: int | None = None,
) -> ProjectResult:
    """Project samples in ``data`` onto ``loadings`` (p x k).

    ``data``: PLINK root / PlinkDataset (packed path) or an (N, p)
    numeric matrix (R project.R numeric path: scale with orig mean/sd,
    NaN -> 0, then ``X @ loadings / sqrt(div)``, in numpy float64).

    Standardization stats resolution order: ``meansd`` (p x 2 array,
    [mean, sd]); ``maf`` (p,) converted via maf2meansd; ``orig_mean`` /
    ``orig_sd``; else stats computed from the data itself.

    ``device`` defaults to ``cuda`` (float32 runs kernel B2) and raises
    without a GPU; ``device="cpu"`` runs the PyTorch path (float64 by
    default).  ``streaming``/``memory_mb`` stream the packed bytes from
    the host (the reference's online projection, randompca.cpp:790-820).
    ``mesh`` shards the packed operator (parallel/dist.py); the numeric
    path is numpy on the host and ignores it.
    ``check_geno`` is accepted for the JAX package's signature.
    """
    V = np.asarray(loadings, dtype=np.float64)
    if V.ndim == 1:
        V = V[:, None]

    if meansd is not None and maf is not None:
        raise ValueError("give only one of meansd or maf")

    if isinstance(data, str):
        data = PlinkDataset.open(data)

    if isinstance(data, PlinkDataset):
        if V.shape[0] != data.n_snps:
            raise ValueError(
                f"loadings rows ({V.shape[0]}) != number of SNPs "
                f"({data.n_snps})")
        if ref_alleles is not None:
            if len(ref_alleles) != data.n_snps:
                raise ValueError(
                    f"ref_alleles has {len(ref_alleles)} entries for "
                    f"{data.n_snps} SNPs")
            mism = [i for i, a in enumerate(data.ref_alleles)
                    if a != ref_alleles[i]]
            if mism:
                raise ValueError(
                    f"reference alleles mismatch at {len(mism)} SNPs "
                    f"(first at row {mism[0]})")
        if snp_ids is not None and list(data.snp_ids) != list(snp_ids):
            raise ValueError("SNP ids do not match the loadings' SNP ids")

        if (orig_mean is None) != (orig_sd is None):
            raise ValueError("give orig_mean and orig_sd together")
        if orig_mean is not None and (meansd is not None or maf is not None):
            raise ValueError(
                "give only one of orig_mean/orig_sd, meansd, or maf")
        if maf is not None:
            maf = np.asarray(maf, dtype=np.float64)
            if maf.shape != (data.n_snps,):
                raise ValueError(
                    f"maf has shape {maf.shape}; expected "
                    f"({data.n_snps},)")
            ms = maf2meansd(maf)
            mean, sd = ms[:, 0], ms[:, 1]
        elif meansd is not None:
            ms = np.asarray(meansd, dtype=np.float64)
            if ms.ndim != 2 or ms.shape != (data.n_snps, 2):
                raise ValueError(
                    f"meansd has shape {ms.shape}; expected "
                    f"({data.n_snps}, 2) [mean, sd]")
            mean, sd = ms[:, 0], ms[:, 1]
        elif orig_mean is not None:
            # the stored training stats (flashpcaR's PLINK-path
            # orig_mean/orig_sd arguments, project.R:99-152)
            mean = np.asarray(orig_mean, dtype=np.float64)
            sd = np.asarray(orig_sd, dtype=np.float64)
            if mean.shape != (data.n_snps,) or sd.shape != (data.n_snps,):
                raise ValueError(
                    "orig_mean/orig_sd must each have one entry per SNP")
        else:
            mean, sd = data.snp_stats(stand)

        # resolved BEFORE the operator build: a divisor typo fails in
        # milliseconds, not after a biobank-scale stats scan and upload
        div = _resolve_div(divisor, data.n_samples, V.shape[0])
        op = build_packed_operator(
            data, mean, sd, streaming=streaming, memory_mb=memory_mb,
            block_size=block_size, dtype=dtype, device=device, mesh=mesh)
        return ProjectResult(projection=_project_operator(op, V, div))

    # numeric-matrix path (flashpcaR/R/project.R:86-93,149-156)
    X = np.array(data, dtype=np.float64, copy=True)
    if X.ndim != 2 or X.shape[1] != V.shape[0]:
        raise ValueError("X columns must match loadings rows")
    if orig_mean is None or orig_sd is None:
        raise ValueError("numeric projection requires orig_mean and orig_sd")
    orig_mean = np.asarray(orig_mean, dtype=np.float64)
    orig_sd = np.asarray(orig_sd, dtype=np.float64)
    inv = _inv_sd(orig_sd)   # the decode's column-zeroing rule
    Xs = (X - orig_mean[None, :]) * inv[None, :]
    Xs[np.isnan(Xs)] = 0.0
    # divisor='n1' maps to n-1 (the C++ reference, flashpca.cpp:484-500,
    # used throughout).  NOTE the R numeric path's own table maps "n1"
    # to n (project.R:137-142): parity with flashpcaR's numeric path at
    # divisor='n1' differs by sqrt((n-1)/n).
    div = _resolve_div(divisor, X.shape[0], V.shape[0])
    return ProjectResult(projection=Xs @ V / np.sqrt(div))
