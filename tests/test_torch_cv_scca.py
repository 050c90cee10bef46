"""The port's ``cv_scca`` and ``grid_fastpath`` against the JAX
package's.

Inputs (numpy, seeded): a 90 x 50 genotype matrix with 5 phenotypes
carrying two SNP sets' effects (the JAX grid tests' ``xy``); complete
PLINK filesets of 80 x 30 (the JAX PLINK-CV tests'); filesets of 60-63
samples (every n % 4) x 37 SNPs with 5% missing calls and a constant SNP;
and, for the dimension-0 abort, a 60 x 40 matrix whose penalties zero u
after a step in some folds.

Tolerances:

* float64 (the CPU path against the JAX package at x64): pooled
  correlations atol 1e-9; folds, non-zero counts, converged flags and
  the best penalties equal;
* float32 (operators with ``use_kernels=True``, B1's and B2's plain
  versions, against the port's float64 run): correlations atol 1e-4,
  the U/V bar of tests/test_torch_scca.py's float32 case; converged
  flags, non-zero counts and best penalties equal;
* streamed against resident at float64: atol 1e-9.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.models.scca import cv_scca as jcv
from flashpca_tpu.models.scca import grid_fastpath as jgrid_fastpath
import flashpca_tpu_torch as ft
import flashpca_tpu_torch.ops.operator as toper
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.models.scca import grid_fastpath

torch.set_num_threads(2)

tscca_mod = sys.modules["flashpca_tpu_torch.models.scca"]


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(777)
    n, p, k = 90, 50, 5
    X = rng.binomial(2, 0.35, size=(n, p)).astype(np.float64)
    Y = rng.normal(size=(n, k))
    Y[:, 0] += 0.5 * X[:, :4].sum(axis=1)
    Y[:, 1] -= 0.3 * X[:, 10:14].sum(axis=1)
    return X, Y


@pytest.fixture(scope="module")
def complete_plink(tmp_path_factory):
    rng = np.random.default_rng(11)
    n, p = 80, 30
    maf = rng.uniform(0.1, 0.5, size=p)
    geno = rng.binomial(2, maf[None, :], size=(n, p)).astype(np.float64)
    root = str(tmp_path_factory.mktemp("cvplink") / "toy")
    write_bed(root, geno)
    return root, geno


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    """PLINK filesets of n = 60..63 samples and their phenotypes, keyed
    by n % 4."""
    out = {}
    base = tmp_path_factory.mktemp("cv")
    for n in (60, 61, 62, 63):
        rng = np.random.default_rng(200 + n)
        p = 37
        maf = rng.uniform(0.05, 0.5, size=p)
        geno = rng.binomial(2, maf[None, :], size=(n, p)).astype(np.float64)
        geno[rng.uniform(size=geno.shape) < 0.05] = np.nan
        geno[:, 5] = 0.0
        root = str(base / f"g{n}")
        write_bed(root, geno)
        Y = rng.normal(size=(n, 4))
        Y[:, 0] += 0.6 * np.nan_to_num(geno[:, :3]).sum(axis=1)
        out[n % 4] = (root, geno, Y)
    return out


def same_cv(got, want, corr_atol=1e-9):
    """Two CVSCCAResults equal: folds, flags, counts and the best cell
    exactly, the pooled correlations within ``corr_atol``."""
    np.testing.assert_array_equal(got.folds, want.folds)
    assert got.nfolds == want.nfolds
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.nzero_x, want.nzero_x)
    np.testing.assert_array_equal(got.nzero_y, want.nzero_y)
    np.testing.assert_array_equal(np.isfinite(got.corr),
                                  np.isfinite(want.corr))
    np.testing.assert_allclose(got.corr, want.corr, rtol=0, atol=corr_atol)
    assert (got.best_lambda1, got.best_lambda2) == (want.best_lambda1,
                                                    want.best_lambda2)
    assert abs(got.best_corr - want.best_corr) <= corr_atol


# ---------------------------------------------------------------------------
# grid_fastpath
# ---------------------------------------------------------------------------

FASTPATH_CASES = [
    ({"maxiter": 9, "engine": "auto", "streaming": "auto",
      "memory_mb": 64}, ()),
    ({"engine": "host"}, ()),
    ({"state_out": "x.npz"}, ()),
    ({"stand_x": "binom"}, ()),
    ({"stand_x": "binom"}, (("stand_x", "stand_y"),)),
    ({"V0": None, "engine": "device"}, (("V0",),)),
    ({"engine": "device", "streaming": True}, ()),
    ({"engine": "device", "memory_mb": 8}, ()),
    ({"engine": "auto", "streaming": True, "memory_mb": 8}, ()),
    ({"dtype": "float32", "seed": 3, "tol": 1e-4, "divisor": "n1",
      "block_size": 8, "auto_init": True, "mesh": None, "maxiter": 5}, ()),
    ({"engine": "bogus"}, ()),
]


@pytest.mark.parametrize("kwargs, extra", FASTPATH_CASES)
def test_grid_fastpath_matches_jax(kwargs, extra):
    """The port's (ok, gkw) is the JAX package's on every keyword the
    two share, the engine gate and the resolved keywords' drop."""
    assert grid_fastpath(dict(kwargs), *extra) == jgrid_fastpath(
        dict(kwargs), *extra)


def test_grid_fastpath_accepts_device():
    """``device`` rides the grid (the JAX package has no such keyword):
    without it in the compatible set every call naming its device would
    take the sequential fallback."""
    ok, gkw = grid_fastpath({"device": "cpu", "engine": "auto",
                             "memory_mb": None, "tol": 1e-5})
    assert ok and gkw == {"device": "cpu", "tol": 1e-5}
    assert not grid_fastpath({"device": "cpu", "engine": "host"})[0]
    assert "device" in tscca_mod.GRID_COMPAT_KWARGS
    assert tscca_mod.GRID_COMPAT_KWARGS - {"device"} == (
        sys.modules["flashpca_tpu.models.scca"].GRID_COMPAT_KWARGS)


# ---------------------------------------------------------------------------
# cv_scca against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "host"])
@pytest.mark.parametrize("init", [True, False])
def test_cv_scca_matrix_matches_jax(xy, engine, init):
    """The matrix path (a DenseOperator a fold), on the grid engine and
    on the sequential fallback, with and without the init run."""
    X, Y = xy
    kw = dict(ndim=2, nfolds=3, seed=4, maxiter=600, tol=1e-8, init=init,
              engine=engine)
    l1, l2 = [1e-6, 2e-2, 0.2], [1e-6, 1e-2]
    got = ft.cv_scca(X, Y, l1, l2, device="cpu", **kw)
    same_cv(got, jcv(X, Y, l1, l2, **kw))
    assert got.converged.any() and np.isfinite(got.best_corr)


@pytest.mark.parametrize("engine", ["auto", "host"])
@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
def test_cv_scca_plink_matches_jax(filesets, nmod, engine):
    """The packed path (a repack a fold, packed train operators, the
    raw-dosage test projector) on every n % 4 of the source; the folds'
    sample counts are arbitrary, so their last bytes are padding."""
    root, _, Y = filesets[nmod]
    kw = dict(ndim=2, nfolds=3, seed=5 + nmod, maxiter=800, tol=1e-8,
              engine=engine, init=nmod % 2 == 0)
    l1, l2 = [1e-4, 2e-2], [1e-4, 1e-2]
    got = ft.cv_scca(root, Y, l1, l2, device="cpu", **kw)
    same_cv(got, jcv(root, Y, l1, l2, **kw))
    assert got.converged.all()


def test_cv_scca_plink_matches_matrix(complete_plink, rng):
    """On complete data the packed path is the matrix path (the JAX
    test's parity), in the port."""
    root, X = complete_plink
    Y = rng.normal(size=(X.shape[0], 3))
    kw = dict(ndim=2, nfolds=3, opt_dim=1, seed=5, tol=1e-9, device="cpu")
    l1, l2 = np.array([1e-4, 1e-3]), np.array([1e-4, 1e-3])
    res_m = ft.cv_scca(X, Y, l1, l2, **kw)
    res_p = ft.cv_scca(root, Y, l1, l2, **kw)
    np.testing.assert_array_equal(res_m.folds, res_p.folds)
    assert (res_p.best_lambda1, res_p.best_lambda2) == (
        res_m.best_lambda1, res_m.best_lambda2)
    np.testing.assert_allclose(res_p.corr, res_m.corr, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res_p.nzero_x, res_m.nzero_x)
    assert res_p.converged.all()


@pytest.mark.parametrize("kind", ["plink", "matrix"])
def test_cv_scca_explicit_folds_match_jax(complete_plink, kind):
    root, X = complete_plink
    Y = np.random.default_rng(3).normal(size=(X.shape[0], 2))
    folds = np.arange(X.shape[0]) % 2
    data = root if kind == "plink" else X
    kw = dict(ndim=2, folds=folds, seed=3, tol=1e-8)
    got = ft.cv_scca(data, Y, [1e-4], [1e-3], device="cpu", **kw)
    assert got.nfolds == 2
    np.testing.assert_array_equal(got.folds, folds)
    same_cv(got, jcv(data, Y, [1e-4], [1e-3], **kw))


@pytest.mark.parametrize("kind", ["plink", "matrix"])
def test_cv_scca_empty_fold_matches_jax(complete_plink, kind):
    """An unused fold label trains and counts and projects nothing (the
    packed path does not repack an empty set)."""
    root, X = complete_plink
    Y = np.random.default_rng(7).normal(size=(X.shape[0], 2))
    folds = (np.arange(X.shape[0]) % 2) * 2      # labels {0, 2}
    data = root if kind == "plink" else X
    kw = dict(ndim=2, opt_dim=1, seed=7, tol=1e-8, folds=folds)
    got = ft.cv_scca(data, Y, [1e-4], [1e-3], device="cpu", **kw)
    assert got.nfolds == 3
    same_cv(got, jcv(data, Y, [1e-4], [1e-3], **kw))


@pytest.mark.parametrize("init", [True, False])
def test_cv_scca_streamed_matches_resident_and_jax(complete_plink, init):
    """``streaming=True, memory_mb=1``: the host grid engine on streamed
    train operators, the resident run's result and the JAX package's
    streamed one."""
    root, X = complete_plink
    Y = np.random.default_rng(5).normal(size=(X.shape[0], 2))
    kw = dict(ndim=2, folds=np.arange(X.shape[0]) % 3, seed=5, tol=1e-9,
              init=init)
    l1, l2 = np.array([1e-4, 1e-3]), np.array([1e-4])
    res_r = ft.cv_scca(root, Y, l1, l2, device="cpu", **kw)
    res_s = ft.cv_scca(root, Y, l1, l2, device="cpu", streaming=True,
                       memory_mb=1, **kw)
    same_cv(res_s, res_r)
    same_cv(res_s, jcv(root, Y, l1, l2, streaming=True, memory_mb=1, **kw))


def test_cv_scca_plink_cleans_scratch(complete_plink, monkeypatch,
                                      tmp_path):
    """Without a workdir each fold's filesets are removed as it ends and
    the temporary directory with them."""
    root, X = complete_plink
    Y = np.random.default_rng(2).normal(size=(X.shape[0], 2))
    made = []
    real = tempfile.mkdtemp

    def spy(*a, **k):
        k.setdefault("dir", str(tmp_path))
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    removed = []
    real_remove = os.remove
    monkeypatch.setattr(os, "remove",
                        lambda p: (removed.append(p), real_remove(p)))
    ft.cv_scca(root, Y, [1e-4], [1e-3], ndim=1, nfolds=2, seed=3, tol=1e-8,
               device="cpu")
    assert len(made) == 1 and not os.path.exists(made[0])
    assert len(removed) == 12            # 2 folds x (train, test) x 3 files


def test_cv_scca_plink_explicit_workdir_kept(complete_plink, tmp_path):
    root, X = complete_plink
    Y = np.random.default_rng(2).normal(size=(X.shape[0], 2))
    wd = str(tmp_path / "folds")
    kw = dict(ndim=1, nfolds=2, seed=3, tol=1e-8, workdir=wd)
    ft.cv_scca(root, Y, [1e-4], [1e-3], device="cpu", **kw)
    kept = sorted(f for f in os.listdir(wd) if f.endswith(".bed"))
    assert kept == ["toy_f0_test.bed", "toy_f0_train.bed",
                    "toy_f1_test.bed", "toy_f1_train.bed"]
    # the repacked folds are the JAX package's byte for byte
    jwd = str(tmp_path / "jfolds")
    jcv(root, Y, [1e-4], [1e-3], **dict(kw, workdir=jwd))
    for f in os.listdir(wd):
        with open(os.path.join(wd, f), "rb") as a, \
                open(os.path.join(jwd, f), "rb") as b:
            assert a.read() == b.read(), f


def test_cv_scca_refusals(complete_plink, xy, tmp_path):
    """The refusals of the JAX package, with its messages; a ``mesh=``
    that conflicts with ``device=`` raises before any repack, and on the
    matrix path a mesh is noted and ignored, as in the JAX package."""
    root, X = complete_plink
    Y = np.random.default_rng(1).normal(size=(X.shape[0], 2))
    args = (Y, [1e-4], [1e-3])
    kw = dict(ndim=1, nfolds=2, device="cpu")
    for bad in ("state_out", "state_in"):
        for data in (root, X):
            with pytest.raises(ValueError, match="cannot be forwarded"):
                ft.cv_scca(data, *args, **kw, **{bad: "s.npz"})
    for extra in ({"streaming": True}, {"memory_mb": 8}):
        with pytest.raises(ValueError, match="needs packed genotypes"):
            ft.cv_scca(X, *args, **kw, **extra)
        with pytest.raises(ValueError, match="needs a resident operator"):
            ft.cv_scca(root, *args, engine="device", **kw, **extra)
    wd = str(tmp_path / "wd")
    from flashpca_tpu_torch.parallel import snp_mesh

    with pytest.raises(ValueError, match="conflicts with the mesh"):
        ft.cv_scca(root, *args, mesh=snp_mesh(["cpu"] * 2), workdir=wd,
                   **dict(kw, device="cuda"))
    assert not os.path.exists(wd)
    with pytest.raises(ValueError, match="opt_dim must be between"):
        ft.cv_scca(X, *args, opt_dim=2, **kw)
    with pytest.raises(ValueError, match="nfolds is too large"):
        ft.cv_scca(root, *args, ndim=1, nfolds=500, device="cpu")
    with pytest.raises(ValueError, match="one entry per sample"):
        ft.cv_scca(X, *args, ndim=1, folds=np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="same number of rows"):
        ft.cv_scca(X[:-1], *args, **kw)
    with pytest.raises(ValueError, match="Y rows must match"):
        ft.cv_scca(root, Y[:-1], [1e-4], [1e-3], **kw)
    Xm, Ym = xy
    a = ft.cv_scca(Xm, Ym, [1e-4], [1e-3], ndim=1, nfolds=2, device="cpu",
                   mesh=object())
    same_cv(a, ft.cv_scca(Xm, Ym, [1e-4], [1e-3], ndim=1, nfolds=2,
                          device="cpu"), corr_atol=0)


def test_cv_scca_raises_without_gpu(complete_plink, monkeypatch, tmp_path):
    """The default device is the card: without one both paths raise,
    the packed one before it writes a fold."""
    root, X = complete_plink
    Y = np.random.default_rng(1).normal(size=(X.shape[0], 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = str(tmp_path / "wd")
    for data in (root, X):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ft.cv_scca(data, Y, [1e-4], [1e-3], ndim=1, nfolds=2,
                       workdir=wd)
    assert not os.path.exists(wd)


class _Float32Kernels(toper.PackedOperator):
    """A packed operator at float32 (unless float64 is asked for)
    through the kernel wrappers (their plain versions on the CPU)."""

    def __init__(self, *a, **kw):
        if kw.get("dtype") in (None, torch.float32):
            kw.update(dtype=torch.float32, use_kernels=True)
        super().__init__(*a, **kw)


def float32_kernel_operators(monkeypatch):
    """Build every packed operator as :class:`_Float32Kernels` and count
    the calls of B1's and B2's plain versions."""
    monkeypatch.setattr(toper, "PackedOperator", _Float32Kernels)
    calls = {"crossprod": 0, "matvec": 0}
    for name in calls:
        plain = getattr(tpk, f"{name}_plain")

        def spy(*a, _plain=plain, _name=name):
            calls[_name] += 1
            return _plain(*a)

        monkeypatch.setattr(tpk, f"{name}_plain", spy)
    return calls


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_cv_scca_float32_through_kernel_wrappers(filesets, monkeypatch,
                                                 engine):
    """float32 train and test operators through the kernel wrappers (B1
    and B2's plain versions on the CPU, no launch) against the port's
    float64 run and the JAX package's."""
    root, _, Y = filesets[1]
    kw = dict(ndim=2, nfolds=3, seed=9, maxiter=2000, tol=1e-5,
              engine=engine)
    l1, l2 = [1e-4, 2e-2], [1e-4, 1e-2]
    want = jcv(root, Y, l1, l2, **kw)
    same_cv(ft.cv_scca(root, Y, l1, l2, device="cpu", **kw), want)
    calls = float32_kernel_operators(monkeypatch)
    tpk.reset_launch_counts()
    got = ft.cv_scca(root, Y, l1, l2, device="cpu", dtype=torch.float32,
                     **kw)
    assert set(tpk.launch_counts.values()) == {0}
    assert calls["crossprod"] > 0 and calls["matvec"] > 0
    same_cv(got, want, corr_atol=1e-4)


# ---------------------------------------------------------------------------
# the dimension-0 abort of the sequential fallback
# ---------------------------------------------------------------------------

def _abort_case(seed=9):
    """A 60 x 40 matrix and a grid on which, in some folds, the JAX
    package's solo host loop zeroes u at dimension 0 after a step."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.3, size=(60, 40)).astype(np.float64)
    Y = rng.normal(size=(60, 5))
    Y[:, 0] += 0.3 * X[:, :3].sum(axis=1)
    return X, Y, np.linspace(0.3, 0.5, 9), [1e-3, 0.2, 0.45]


def test_cv_scca_dim0_abort_matches_jax():
    """The sequential fallback (engine='host': solo scca() runs) keeps
    the vector of the step before a dimension-0 abort, as the JAX
    package's solo host loop does, so its mean non-zeros are the JAX
    package's; the grid engine keeps the zeroed vector (both packages),
    which is how the case shows that such an abort happened."""
    X, Y, l1, l2 = _abort_case()
    kw = dict(ndim=2, nfolds=3, seed=9, maxiter=200, tol=1e-6,
              stand_x="sd", init=False)
    host = ft.cv_scca(X, Y, l1, l2, engine="host", device="cpu", **kw)
    same_cv(host, jcv(X, Y, l1, l2, engine="host", **kw))
    grid = ft.cv_scca(X, Y, l1, l2, device="cpu", **kw)
    same_cv(grid, jcv(X, Y, l1, l2, **kw))
    assert (host.nzero_x != grid.nzero_x).sum() >= 1


def test_solo_host_scca_dim0_abort_matches_jax():
    """A solo scca(engine='host') whose u is zeroed at dimension 0 after
    a step keeps the u of that step (one non-zero) as the JAX package
    does, and one whose v is zeroed keeps the v before."""
    from flashpca_tpu.models.scca import scca as jscca

    for seed, l1, l2, which in ((7, 0.45, 0.2, "U"), (9, 0.1, 0.55, "V")):
        rng = np.random.default_rng(seed)
        X = rng.binomial(2, 0.3, size=(60, 40)).astype(np.float64)
        Y = rng.normal(size=(60, 5))
        Y[:, 0] += 0.3 * X[:, :3].sum(axis=1)
        kw = dict(ndim=2, maxiter=200, tol=1e-6, V0=rng.normal(size=(5, 2)),
                  engine="host", stand_x="sd")
        got = ft.scca(X, Y, l1, l2, device="cpu", **kw)
        want = jscca(X, Y, l1, l2, **kw)
        assert not got.converged and not want.converged
        for key in ("U", "V", "d"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       rtol=1e-9, atol=1e-12)
        assert np.count_nonzero(getattr(got, which)[:, 0]) > 0
        dev = ft.scca(X, Y, l1, l2, device="cpu",
                      **dict(kw, engine="device"))
        assert np.count_nonzero(getattr(dev, which)[:, 0]) == 0
