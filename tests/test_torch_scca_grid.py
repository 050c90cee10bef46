"""The port's ``scca_grid()`` against per-cell solo runs of its own
``scca()`` and the JAX package's ``scca_grid``.

Inputs (numpy, seeded): a 90 x 50 genotype matrix with 5 phenotypes,
two of them carrying SNP effects (seed 777, the JAX test's), PLINK
filesets of 60-63 samples (every n % 4, from test_torch_scca) and the
suite's ``small_plink``.

Tolerances: against solo runs atol 1e-10 on U, V and d (1e-9 through a
streaming operator, whose prod sums its blocks in another order), the
iterations per dimension equal;
against the JAX grid at float64 rtol 1e-9 / atol 1e-10, with the
per-cell iteration counts and converged flags equal.
"""

import numpy as np
import pytest
import torch

from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.models.scca import scca_grid as jscca_grid
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.models.scca import make_gaussian

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gxy():
    rng = np.random.default_rng(777)
    n, p, k = 90, 50, 5
    X = rng.binomial(2, 0.35, size=(n, p)).astype(np.float64)
    Y = rng.normal(size=(n, k))
    Y[:, 0] += 0.5 * X[:, :4].sum(axis=1)
    Y[:, 1] -= 0.3 * X[:, 10:14].sum(axis=1)
    return X, Y


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    """PLINK filesets of n = 60..63 samples (every n % 4) and their
    phenotypes, keyed by n % 4 (as test_torch_scca's)."""
    out = {}
    base = tmp_path_factory.mktemp("scca_grid")
    for n in (60, 61, 62, 63):
        rng = np.random.default_rng(100 + n)
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


def _same_grid(got, want, atol=1e-10):
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_allclose(got.lambda1, want.lambda1)
    np.testing.assert_allclose(got.lambda2, want.lambda2)
    for key in ("U", "V", "d", "V0"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=1e-9, atol=atol, err_msg=key)


def _solos(X, Y, lam1_c, lam2_c, V0, **kw):
    return [ft.scca(X, Y, float(a), float(b), V0=V0, **kw)
            for a, b in zip(lam1_c, lam2_c)]


def _grid_matches_solos(g, solos, atol=1e-10):
    for c, s in enumerate(solos):
        assert bool(g.converged[c]) == s.converged, f"cell {c}"
        np.testing.assert_allclose(g.U[:, :, c], s.U, atol=atol,
                                   err_msg=f"cell {c} U")
        np.testing.assert_allclose(g.V[:, :, c], s.V, atol=atol,
                                   err_msg=f"cell {c} V")
        np.testing.assert_allclose(g.d[:, c], s.d, atol=atol,
                                   err_msg=f"cell {c} d")
        np.testing.assert_array_equal(g.n_iters[:, c], s.n_iters,
                                      err_msg=f"cell {c} iterations")


def test_grid_matches_solo_runs_and_jax(gxy):
    X, Y = gxy
    ndim = 3
    V0 = make_gaussian(Y.shape[1], ndim, 7)
    l1, l2 = np.array([1e-6, 2e-2]), np.array([1e-6, 1e-2, 5e-2])
    kw = dict(ndim=ndim, maxiter=1000, tol=1e-9)
    g = ft.scca_grid(X, Y, l1, l2, V0=V0, device="cpu", **kw)
    assert g.U.shape == (X.shape[1], ndim, 6)
    np.testing.assert_allclose(g.lambda1, np.repeat(l1, 3))
    np.testing.assert_allclose(g.lambda2, np.tile(l2, 2))
    solos = _solos(X, Y, g.lambda1, g.lambda2, V0, device="cpu", **kw)
    assert all(s.converged for s in solos)
    _grid_matches_solos(g, solos)
    _same_grid(g, jscca_grid(X, Y, l1, l2, V0=V0, **kw))


def test_grid_zero_abort_cell_matches_solo(gxy):
    X, Y = gxy
    V0 = make_gaussian(Y.shape[1], 2, 3)
    kw = dict(ndim=2, maxiter=500, tol=1e-8)
    g = ft.scca_grid(X, Y, [1e-6, 0.9], [1e-6], V0=V0, device="cpu", **kw)
    solos = _solos(X, Y, g.lambda1, g.lambda2, V0, device="cpu", **kw)
    assert solos[0].converged and not solos[1].converged
    _grid_matches_solos(g, solos)
    assert np.all(g.U[:, 1, 1] == 0.0) and np.all(g.n_iters[1:, 1] == 0)
    _same_grid(g, jscca_grid(X, Y, [1e-6, 0.9], [1e-6], V0=V0, **kw))


def test_grid_nonconverged_cell_matches_solo(gxy):
    X, Y = gxy
    V0 = make_gaussian(Y.shape[1], 2, 11)
    kw = dict(ndim=2, maxiter=3, tol=1e-12)
    lam = np.array([1e-6, 5e-3])
    g = ft.scca_grid(X, Y, lam, lam, V0=V0, device="cpu", **kw)
    solos = _solos(X, Y, g.lambda1, g.lambda2, V0, device="cpu", **kw)
    assert not any(s.converged for s in solos)
    _grid_matches_solos(g, solos)
    _same_grid(g, jscca_grid(X, Y, lam, lam, V0=V0, **kw))


def test_grid_pairs_mode(gxy):
    X, Y = gxy
    V0 = make_gaussian(Y.shape[1], 2, 5)
    lam1 = np.array([1e-6, 1e-3, 1e-2])
    lam2 = np.array([1e-5, 1e-4, 1e-3])
    kw = dict(ndim=2, maxiter=1000, tol=1e-9)
    g = ft.scca_grid(X, Y, lam1, lam2, pairs=True, V0=V0, device="cpu",
                     **kw)
    assert len(g.lambda1) == 3
    _grid_matches_solos(g, _solos(X, Y, lam1, lam2, V0, device="cpu", **kw))
    _same_grid(g, jscca_grid(X, Y, lam1, lam2, pairs=True, V0=V0, **kw))
    with pytest.raises(ValueError, match="equal length"):
        ft.scca_grid(X, Y, lam1, lam2[:2], pairs=True, V0=V0, device="cpu",
                     **kw)


@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
def test_grid_on_plink_packed(filesets, nmod):
    """Grid over the packed operator (missing calls, a constant SNP, every
    n % 4) against solo packed runs and the JAX grid."""
    root, _, Y = filesets[nmod]
    V0 = np.random.default_rng(20 + nmod).normal(size=(4, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9)
    g = ft.scca_grid(root, Y, [1e-6, 1e-2], [1e-6], V0=V0, device="cpu",
                     **kw)
    _grid_matches_solos(g, _solos(root, Y, g.lambda1, g.lambda2, V0,
                                  device="cpu", **kw))
    _same_grid(g, jscca_grid(root, Y, [1e-6, 1e-2], [1e-6], V0=V0, **kw))


def _streaming_op(root, **kw):
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    return ft.StreamingPackedOperator(ds, mean, sd, ds.n_samples,
                                      block_snps=16, cache_mb=0,
                                      device="cpu", **kw)


def test_grid_on_streaming_operator_shares_passes(small_plink):
    """A streaming operator rides the host grid engine: per-cell results
    equal sequential solo streaming runs and the JAX host grid, and all
    cells share each staged pass."""
    root, geno = small_plink
    n = geno.shape[0]
    Y = np.random.default_rng(15).normal(size=(n, 3))
    Y[:, 0] += 0.5 * np.nan_to_num(geno[:, :3]).sum(axis=1)
    V0 = np.random.default_rng(16).normal(size=(3, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9)
    op = _streaming_op(root)
    g = ft.scca_grid(op, Y, [1e-6, 1e-2], [1e-6, 1e-3], V0=V0, **kw)
    grid_ops, grid_blocks = op.nops, op.stats()["staged_host_blocks"]
    op2 = _streaming_op(root)
    solos, solo_ops = [], 0
    for a, b in zip(g.lambda1, g.lambda2):
        before = op2.nops
        solos.append(ft.scca(op2, Y, float(a), float(b), V0=V0, **kw))
        solo_ops += op2.nops - before
    _grid_matches_solos(g, solos, atol=1e-9)
    assert grid_ops < solo_ops
    assert grid_blocks == grid_ops * op.n_blocks
    _same_grid(g, jscca_grid(root, Y, [1e-6, 1e-2], [1e-6, 1e-3], V0=V0,
                             streaming=True, block_size=16, **kw))


def test_grid_streaming_memory_mb_matches_resident(small_plink):
    root, geno = small_plink
    Y = np.random.default_rng(17).normal(size=(geno.shape[0], 3))
    V0 = np.random.default_rng(18).normal(size=(3, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, V0=V0, device="cpu")
    g_r = ft.scca_grid(root, Y, [1e-6, 1e-3], [1e-6], **kw)
    g_s = ft.scca_grid(root, Y, [1e-6, 1e-3], [1e-6], streaming=True,
                       memory_mb=1, **kw)
    _same_grid(g_s, g_r, atol=1e-9)


def test_grid_v0_validation_and_unreached_dims(gxy):
    X, Y = gxy
    with pytest.raises(ValueError, match="V0 must be"):
        ft.scca_grid(X, Y, [1e-6], [1e-6], ndim=2,
                     V0=np.zeros((Y.shape[1], 5)), device="cpu")
    # every cell dies at dimension 0: dimension 1 keeps its V0 column
    V0 = make_gaussian(Y.shape[1], 2, 4)
    g = ft.scca_grid(X, Y, [0.9, 0.95], [1e-6], ndim=2, V0=V0,
                     device="cpu")
    assert not g.converged.any()
    np.testing.assert_array_equal(g.V[:, 1, :], np.repeat(V0[:, 1:], 2, 1))
    np.testing.assert_array_equal(g.n_iters[1], [0, 0])


def test_grid_auto_init_matches_solo_auto_init(gxy):
    X, Y = gxy
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, auto_init=True, seed=9,
              device="cpu")
    g = ft.scca_grid(X, Y, [1e-3], [1e-4], **kw)
    s = ft.scca(X, Y, 1e-3, 1e-4, **kw)
    np.testing.assert_allclose(g.V0, s.V0, atol=1e-12)
    np.testing.assert_allclose(g.U[:, :, 0], s.U, atol=1e-10)
    np.testing.assert_allclose(g.d[:, 0], s.d, atol=1e-10)
    kw.pop("device")
    _same_grid(g, jscca_grid(X, Y, [1e-3], [1e-4], **kw))


def test_host_grid_zero_abort_cell_matches_device_grid(small_plink):
    root, geno = small_plink
    Y = np.random.default_rng(19).normal(size=(geno.shape[0], 3))
    V0 = np.random.default_rng(20).normal(size=(3, 2))
    kw = dict(ndim=2, maxiter=500, tol=1e-8, V0=V0)
    g = ft.scca_grid(_streaming_op(root), Y, [1e-6, 0.9], [1e-6], **kw)
    g_dev = ft.scca_grid(root, Y, [1e-6, 0.9], [1e-6], device="cpu", **kw)
    assert g.converged[0] and not g.converged[1]
    _same_grid(g, g_dev, atol=1e-9)
    assert np.all(g.U[:, 1, 1] == 0.0) and np.all(g.n_iters[1:, 1] == 0)


def test_host_grid_nonconverged_cell_matches_solo(small_plink):
    root, geno = small_plink
    Y = np.random.default_rng(21).normal(size=(geno.shape[0], 3))
    V0 = np.random.default_rng(22).normal(size=(3, 2))
    kw = dict(ndim=2, maxiter=2, tol=1e-12, V0=V0)
    g = ft.scca_grid(_streaming_op(root), Y, [1e-6, 5e-3], [1e-6], **kw)
    op2 = _streaming_op(root)
    solos = [ft.scca(op2, Y, float(a), float(b), **kw)
             for a, b in zip(g.lambda1, g.lambda2)]
    assert not any(s.converged for s in solos)
    _grid_matches_solos(g, solos, atol=1e-9)


def test_zero_abort_keeps_v_at_init_all_engines(gxy):
    """A dim-0 u-zero abort keeps V[:, 0] at its init (the reference
    aborts before the v step, randompca.cpp:280-287) on the solo host
    and device engines and the grid, as in the JAX package."""
    X, Y = gxy
    V0 = make_gaussian(Y.shape[1], 1, 3)
    kw = dict(ndim=1, maxiter=500, tol=1e-8, V0=V0, device="cpu")
    host = ft.scca(X, Y, 0.9, 1e-6, engine="host", **kw)
    dev = ft.scca(X, Y, 0.9, 1e-6, engine="device", **kw)
    g = ft.scca_grid(X, Y, [0.9], [1e-6], **kw)
    assert not host.converged and not dev.converged and not g.converged[0]
    for U_got in (host.U, dev.U, g.U[:, :, 0]):
        np.testing.assert_allclose(np.abs(U_got).max(), 0.0, atol=1e-12)
    for V_got in (host.V[:, 0], dev.V[:, 0], g.V[:, 0, 0]):
        np.testing.assert_allclose(V_got, V0[:, 0], atol=1e-7)
