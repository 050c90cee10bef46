"""Plot helpers mirroring the R package's S3 plot methods.

Equivalents of ``plot.cv.scca`` (flashpcaR/R/scca.R:601-644: CV
correlation vs number of non-zero U entries, one curve per lambda2),
``plot2d.cv.scca`` (scca.R:695-719: lambda1 x lambda2 correlation
heatmap) and ``plot2d`` PC scatter.  matplotlib is imported lazily so
the package imports without it (a GPU machine may have none).
"""

from __future__ import annotations

import numpy as np


def plot_cv_scca(res, dim: int = 1, ax=None, **kwargs):
    """CV correlation against mean non-zeros in U, one line per lambda2."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    d = dim - 1
    for j, l2 in enumerate(res.lambda2):
        ax.plot(res.nzero_x[d, :, j], res.corr[d, :, j],
                marker="o", label=f"$\\lambda_2$={l2:g}", **kwargs)
    ax.set_xlabel("mean non-zero entries in U")
    ax.set_ylabel(f"CV correlation (dim {dim})")
    ax.legend(fontsize="small")
    return ax


def plot2d_cv_scca(res, dim: int = 1, ax=None, **kwargs):
    """Heatmap of CV correlation over the lambda1 x lambda2 grid."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    d = dim - 1
    im = ax.imshow(res.corr[d], aspect="auto", origin="lower", **kwargs)
    ax.set_xticks(range(len(res.lambda2)),
                  [f"{v:g}" for v in res.lambda2], rotation=45)
    ax.set_yticks(range(len(res.lambda1)),
                  [f"{v:g}" for v in res.lambda1])
    ax.set_xlabel("$\\lambda_2$")
    ax.set_ylabel("$\\lambda_1$")
    ax.figure.colorbar(im, ax=ax, label=f"CV correlation (dim {dim})")
    return ax


def plot_pcs(result, dims=(1, 2), labels=None, ax=None, **kwargs):
    """2-D PC scatter (the R package's plot2d convenience)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    P = np.asarray(result.projection)
    i, j = dims[0] - 1, dims[1] - 1
    if labels is not None:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            m = labels == lab
            ax.scatter(P[m, i], P[m, j], s=8, label=str(lab), **kwargs)
        ax.legend(fontsize="small")
    else:
        ax.scatter(P[:, i], P[:, j], s=8, **kwargs)
    ax.set_xlabel(f"PC{dims[0]}")
    ax.set_ylabel(f"PC{dims[1]}")
    return ax


def plot_split_scca(res, dim: int = 1, ax=None, **kwargs):
    """Split-validation curves (scca_pred.R:36-42, 74-84): test-set
    canonical correlation vs lambda1, one line per lambda2, with the
    training correlation dashed for comparison."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    d = dim - 1
    for j, l2 in enumerate(res.lambda2):
        ax.plot(res.lambda1, res.corr_test[d, :, j], marker="o",
                label=f"test $\\lambda_2$={l2:g}", **kwargs)
        ax.plot(res.lambda1, res.corr_train[d, :, j], marker=".",
                linestyle="--", alpha=0.5,
                label=f"train $\\lambda_2$={l2:g}", **kwargs)
    if not np.any(np.asarray(res.lambda1) <= 0):
        ax.set_xscale("log")        # lambda1=0 (the unpenalized
        # baseline cell) would silently vanish off a log axis
    ax.set_xlabel("$\\lambda_1$")
    ax.set_ylabel(f"canonical correlation (dim {dim})")
    ax.legend(fontsize="small")
    return ax


def plot_split_scca_sparsity(res, dim: int = 1, ax=None, **kwargs):
    """Test correlation vs number of non-zero U entries (the reference's
    matplot(nzu1, R.trn1) panel, scca_pred.R:40-41)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    d = dim - 1
    for j, l2 in enumerate(res.lambda2):
        ax.plot(res.nzero_x[d, :, j], res.corr_test[d, :, j], marker="o",
                label=f"$\\lambda_2$={l2:g}", **kwargs)
    if np.all(np.asarray(res.nzero_x[d]) > 0):
        ax.set_xscale("log")        # an all-zero U cell (over-penalized)
        # would silently vanish off a log axis
    ax.set_xlabel("non-zero entries in U")
    ax.set_ylabel(f"test correlation (dim {dim})")
    ax.legend(fontsize="small")
    return ax
