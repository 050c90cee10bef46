"""SCCA split validation on PLINK data.

In-framework equivalent of the reference's ``scca.sh`` + ``scca_pred.R``
workflow (scca.sh:39-85, scca_pred.R:17-84):

1. split the samples into train and test (the awk + ``plink --keep``
   step, scca.sh:42-50; here :func:`io.plink.subset_samples_many`);
2. run SCCA on the training set over a (lambda1, lambda2) grid (the
   GNU-parallel flashpca runs, scca.sh:65-79; here one
   :func:`scca_grid`, every cell through shared passes);
3. standardize the test genotypes and phenotypes with the training
   statistics and project them onto each model's U / V (the predict
   step, scca.sh:81-89);
4. score each grid point by the test-set canonical correlations
   ``cor(X_test U_j, Y_test V_j)`` (scca_pred.R:74-80).

The genotypes stay 2-bit packed throughout; both projections are one
packed-operator product each over all cells (B2 on a float32 CUDA
operator).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np

from ..io.plink import PlinkDataset, subset_samples_many
from ..ops.operator import build_packed_operator
from ..ops.standardize import VAR_TOL, standardize
from ..utils.device import host64
from ..utils.logging import log
from .scca import (_penalty_axis, _plink_operator_options, _project_cells,
                   _refuse_auto_streamed, grid_fastpath, scca, scca_grid,
                   search_device, shared_repack)


@dataclass
class SplitSCCAResult:
    train_idx: np.ndarray     # sample indices of the training split
    test_idx: np.ndarray
    lambda1: np.ndarray
    lambda2: np.ndarray
    ndim: int
    corr_train: np.ndarray    # (ndim, n1, n2) train canonical corr
    corr_test: np.ndarray     # (ndim, n1, n2) test canonical corr
    nzero_x: np.ndarray       # (ndim, n1, n2) non-zeros in U
    nzero_y: np.ndarray
    converged: np.ndarray     # (n1, n2)
    opt_dim: int
    best_lambda1: float
    best_lambda2: float
    best_corr: float

    def __repr__(self):
        return (f"SplitSCCAResult(best_lambda1={self.best_lambda1:g}, "
                f"best_lambda2={self.best_lambda2:g}, "
                f"best_corr={self.best_corr:.4f})")


def _diag_corr(A, B):
    """Pearson correlation of each column pair (NaN for a constant one)."""
    out = np.full(A.shape[1], np.nan)
    for j in range(A.shape[1]):
        a, b = A[:, j], B[:, j]
        if a.std() > 0 and b.std() > 0:
            out[j] = np.corrcoef(a, b)[0, 1]
    return out


def split_scca(
    data,
    Y: np.ndarray,
    lambda1=None,
    lambda2=None,
    *,
    ndim: int = 10,
    prop_train: float = 0.8,
    seed: int = 1,
    opt_dim: int = 1,
    stand_x: str = "binom2",
    stand_y: str = "sd",
    workdir: str | None = None,
    verbose: bool = False,
    **scca_kwargs,
) -> SplitSCCAResult:
    """Train/test split validation of SCCA penalties on PLINK data.

    ``data``: PLINK root / PlinkDataset.  ``Y``: (N, k) phenotypes in
    .fam order (scca.sh requires the same order, scca.sh:15-17).  The
    split is ``default_rng(seed).uniform(size=N) < prop_train`` (the awk
    ``rand() < p`` split).  ``workdir``: where the train and test
    filesets are written and kept (by default a temporary directory,
    removed on success).  Further keywords go to :func:`scca` /
    :func:`scca_grid` (e.g. ``maxiter``, ``tol``, ``streaming``,
    ``dtype``); ``device`` defaults to ``cuda`` and raises without a
    GPU.  ``mesh`` builds both operators sharded (parallel/dist.py);
    across processes a named ``workdir`` is written by rank 0 alone."""
    for bad in ("state_out", "state_in"):
        if bad in scca_kwargs:
            raise ValueError(
                f"{bad} cannot be forwarded to a penalty grid: every "
                "(lambda1, lambda2) cell would overwrite the same file; "
                "checkpoint individual scca() runs instead")
    if isinstance(data, str):
        data = PlinkDataset.open(data)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n = data.n_samples
    if Y.shape[0] != n:
        raise ValueError("Y rows must match the number of samples")
    if not (0.0 < prop_train < 1.0):
        raise ValueError("prop_train must be in (0, 1)")
    lambda1 = _penalty_axis(lambda1, np.linspace(1e-3, 5e-3, 5))
    lambda2 = _penalty_axis(lambda2, np.array([1e-5, 1e-4, 1e-3]))
    if not (1 <= opt_dim <= ndim):
        raise ValueError("opt_dim must be between 1 and ndim")

    rng = np.random.default_rng(seed)
    train = rng.uniform(size=n) < prop_train     # awk rand() < p split
    if train.all() or not train.any():
        raise ValueError("degenerate train/test split; adjust prop_train")
    train_idx = np.flatnonzero(train)
    test_idx = np.flatnonzero(~train)
    op_opts = _plink_operator_options(scca_kwargs)
    op_opts["device"] = search_device(op_opts)

    cleanup = workdir is None
    if cleanup:
        workdir = tempfile.mkdtemp(prefix="scca_split_")
    else:
        os.makedirs(workdir, exist_ok=True)
    base = os.path.basename(data.bed_path)[:-4]
    # both filesets from one read of the source
    subsets = [(train_idx, os.path.join(workdir, base + "_train")),
               (test_idx, os.path.join(workdir, base + "_test"))]
    shared_repack(op_opts["mesh"], None if cleanup else workdir,
                  lambda: subset_samples_many(data, subsets))
    ds_train, ds_test = (PlinkDataset.open(root) for _, root in subsets)

    Y_train = Y[train_idx]
    # the training standardization, applied to both splits; a missing
    # test phenotype becomes the training mean (0 after standardization),
    # as the training side's standardize() does
    Yt_std, y_mean, y_sd = standardize(Y_train.copy(), stand_y)
    y_inv = np.where(y_sd > VAR_TOL,
                     1.0 / np.where(y_sd > VAR_TOL, y_sd, 1.0), 0.0)
    Yte_std = (Y[test_idx] - y_mean[None, :]) * y_inv[None, :]
    Yte_std[np.isnan(Yte_std)] = 0.0
    # the test genotypes stay packed: an operator over the test fileset
    # with the training stats projects them through prod()
    x_mean, x_sd = ds_train.snp_stats(stand_x)
    op_test = build_packed_operator(ds_test, x_mean, x_sd, **op_opts)
    _refuse_auto_streamed(scca_kwargs, op_test)
    # one train operator for the whole grid
    op_train = build_packed_operator(ds_train, x_mean, x_sd, **op_opts)

    n1, n2 = len(lambda1), len(lambda2)
    corr_train = np.full((ndim, n1, n2), np.nan)
    corr_test = np.full((ndim, n1, n2), np.nan)
    nzx = np.zeros((ndim, n1, n2))
    nzy = np.zeros((ndim, n1, n2))
    conv = np.zeros((n1, n2), dtype=bool)

    grid_ok, gkw = grid_fastpath(scca_kwargs, ("V0",))
    if grid_ok:
        # every cell rides the same genotype panel pass a step
        gkw.setdefault("seed", seed)
        g = scca_grid(op_train, Y_train, lambda1, lambda2, ndim=ndim,
                      stand_x=stand_x, stand_y=stand_y, verbose=verbose,
                      **gkw)
        conv[:] = g.converged.reshape(n1, n2)
        nzx[:] = np.count_nonzero(g.U, axis=0).reshape(ndim, n1, n2)
        nzy[:] = np.count_nonzero(g.V, axis=0).reshape(ndim, n1, n2)
        # the train and test projections of every cell, one product each
        # (the invdiv scaling drops out of the correlations)
        px_tr = _project_cells(op_train, g.U)
        px_te = _project_cells(op_test, g.U)
        for c in np.flatnonzero(g.converged):
            i, j = divmod(int(c), n2)
            corr_train[:, i, j] = _diag_corr(px_tr[:, :, c],
                                             Yt_std @ g.V[:, :, c])
            corr_test[:, i, j] = _diag_corr(px_te[:, :, c],
                                            Yte_std @ g.V[:, :, c])
    else:
        log("split_scca: sequential per-cell fallback (host engine or "
            "keywords outside GRID_COMPAT_KWARGS)", verbose=verbose)
        for i, l1 in enumerate(lambda1):
            for j, l2 in enumerate(lambda2):
                log(f"-> lambda1={l1:g} lambda2={l2:g}", verbose=verbose)
                res = scca(op_train, Y_train, float(l1), float(l2),
                           ndim=ndim, stand_x=stand_x, stand_y=stand_y,
                           seed=seed, verbose=verbose, **scca_kwargs)
                conv[i, j] = res.converged
                nzx[:, i, j] = np.count_nonzero(res.U, axis=0)
                nzy[:, i, j] = np.count_nonzero(res.V, axis=0)
                if not res.converged:
                    continue
                corr_train[:, i, j] = _diag_corr(res.Px, res.Py)
                corr_test[:, i, j] = _diag_corr(
                    host64(op_test.prod(res.U)), Yte_std @ res.V)

    sl = corr_test[opt_dim - 1]
    if np.all(np.isnan(sl)):
        raise RuntimeError("no model converged on any penalty pair")
    best = np.unravel_index(np.nanargmax(sl), sl.shape)
    if cleanup:
        # the default workdir's filesets are the dataset's size: removed
        # on success (kept on failure for debugging, and whenever the
        # caller named the workdir)
        import shutil

        for dsx in (ds_train, ds_test):
            dsx._mmap = None
        shutil.rmtree(workdir, ignore_errors=True)
    return SplitSCCAResult(
        train_idx=train_idx, test_idx=test_idx,
        lambda1=lambda1, lambda2=lambda2, ndim=ndim,
        corr_train=corr_train, corr_test=corr_test,
        nzero_x=nzx, nzero_y=nzy, converged=conv, opt_dim=opt_dim,
        best_lambda1=float(lambda1[best[0]]),
        best_lambda2=float(lambda2[best[1]]),
        best_corr=float(sl[best]),
    )
