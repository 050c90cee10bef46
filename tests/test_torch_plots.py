"""The port's plot helpers against the JAX package's, under matplotlib's
Agg backend: each helper drawn on the same inputs by both packages (the
port's cv_scca / split_scca / pca results and the JAX package's, equal
at float64), and every axis compared -- its lines' and collections'
data, labels, ticks and scales.  matplotlib loads lazily in both, so
importing the port needs none."""

import os
import subprocess
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from flashpca_tpu import plots as jplots  # noqa: E402
from flashpca_tpu.models.pca import pca as jpca  # noqa: E402
from flashpca_tpu.models.scca import cv_scca as jcv  # noqa: E402
from flashpca_tpu.models.scca_split import split_scca as jsplit  # noqa: E402
import flashpca_tpu_torch as ft  # noqa: E402
from flashpca_tpu_torch import plots as tplots  # noqa: E402


def describe(ax):
    """What an axis shows, as plain data."""
    out = {"xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
           "xscale": ax.get_xscale(), "yscale": ax.get_yscale(),
           "xticks": [t.get_text() for t in ax.get_xticklabels()],
           "yticks": [t.get_text() for t in ax.get_yticklabels()],
           "lines": [(ln.get_label(), np.asarray(ln.get_xydata()),
                      ln.get_marker(), ln.get_linestyle())
                     for ln in ax.get_lines()],
           "collections": [np.asarray(c.get_offsets())
                           for c in ax.collections],
           "images": [np.asarray(im.get_array()) for im in ax.get_images()],
           "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                      if ax.get_legend() else None)}
    return out


def same_axes(a, b):
    da, db = describe(a), describe(b)
    for key in ("xlabel", "ylabel", "xscale", "yscale", "xticks", "yticks",
                "legend"):
        assert da[key] == db[key], key
    assert len(da["lines"]) == len(db["lines"])
    for (la, xa, ma, sa), (lb, xb, mb, sb) in zip(da["lines"], db["lines"]):
        assert (la, ma, sa) == (lb, mb, sb)
        np.testing.assert_allclose(xa, xb, rtol=0, atol=1e-9)
    for key in ("collections", "images"):
        assert len(da[key]) == len(db[key]), key
        for xa, xb in zip(da[key], db[key]):
            np.testing.assert_allclose(xa, xb, rtol=0, atol=1e-9)


def draw(fn, res, **kw):
    fig, ax = plt.subplots()
    fn(res, ax=ax, **kw)
    return fig, ax


@pytest.fixture(scope="module")
def cv_results():
    rng = np.random.default_rng(12)
    n, p = 60, 20
    X = rng.standard_normal((n, p))
    Y = X[:, :2] + 0.5 * rng.standard_normal((n, 2))
    kw = dict(lambda1=[1e-6, 1e-3, 5e-2], lambda2=[1e-6, 1e-2], ndim=1,
              nfolds=2, seed=2, stand_x="sd", stand_y="sd", maxiter=100,
              tol=1e-3)
    return ft.cv_scca(X, Y, device="cpu", **kw), jcv(X, Y, **kw)


@pytest.fixture(scope="module")
def split_results(small_plink, tmp_path_factory):
    root, geno = small_plink
    rng = np.random.default_rng(5)
    Y = rng.normal(size=(geno.shape[0], 2))
    Y[:, 0] += 0.8 * np.nan_to_num(geno[:, :4]).sum(axis=1)
    kw = dict(lambda1=[1e-3, 1e-2, 5e-2], lambda2=[1e-4, 1e-2], ndim=2,
              prop_train=0.7, seed=5, maxiter=300, tol=1e-5)
    return ft.split_scca(root, Y, device="cpu", **kw), jsplit(root, Y, **kw)


@pytest.mark.parametrize("name", ["plot_cv_scca", "plot2d_cv_scca"])
def test_cv_plots_match_jax(cv_results, name):
    got, want = cv_results
    a = draw(getattr(tplots, name), got, dim=1)[1]
    b = draw(getattr(jplots, name), want, dim=1)[1]
    same_axes(a, b)
    plt.close("all")


@pytest.mark.parametrize("name", ["plot_split_scca",
                                  "plot_split_scca_sparsity"])
@pytest.mark.parametrize("dim", [1, 2])
def test_split_plots_match_jax(split_results, name, dim):
    got, want = split_results
    a = draw(getattr(tplots, name), got, dim=dim)[1]
    b = draw(getattr(jplots, name), want, dim=dim)[1]
    same_axes(a, b)
    assert a.get_xlabel() and a.get_ylabel()
    plt.close("all")


@pytest.mark.parametrize("labels", [None, "pops"])
def test_plot_pcs_matches_jax(labels):
    rng = np.random.default_rng(3)
    n, p = 60, 20
    X = rng.standard_normal((n, p))
    lab = None if labels is None else np.arange(n) % 3
    got = ft.pca(X, 3, stand="sd", tol=1e-8, device="cpu")
    want = jpca(X, 3, stand="sd", tol=1e-8)
    a = draw(tplots.plot_pcs, got, labels=lab)[1]
    b = draw(jplots.plot_pcs, want, labels=lab)[1]
    # the PCs agree up to each column's sign
    sa = np.sign(got.projection[0, :2])
    sb = np.sign(want.projection[0, :2])
    for ca, cb in zip(describe(a)["collections"], describe(b)["collections"]):
        np.testing.assert_allclose(ca * sa, cb * sb, rtol=0, atol=1e-8)
    da, db = describe(a), describe(b)
    for key in ("xlabel", "ylabel", "legend"):
        assert da[key] == db[key]
    plt.close("all")


def test_plots_default_axes_and_lazy_import():
    """Without ``ax`` each helper makes its own figure; the port's
    package imports with matplotlib absent."""
    res = ft.pca(np.random.default_rng(4).standard_normal((30, 10)), 2,
                 stand="sd", device="cpu")
    ax = tplots.plot_pcs(res)
    assert ax.get_xlabel() == "PC1"
    plt.close("all")
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import flashpca_tpu_torch as ft; print(ft.plots.__name__)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=repo).stdout
    assert out.strip() == "flashpca_tpu_torch.plots"
