"""The port's analysis modes on a SNP-sharded mesh against the JAX
package's on its 4-device CPU mesh (the counterpart of
tests/test_mesh_modes.py), and the penalty searches on a 2-shard mesh
against their unsharded runs.

The port's mesh repeats ``"cpu"``; the JAX package's is four virtual
CPU devices (tests/conftest.py).  Both are float64 here.

Tolerances, with their reasons (tests/test_mesh_modes.py's bars unless
said otherwise):

* ``scca``: d rtol 1e-8, U/V/Px rtol 1e-7 (the power iteration amplifies
  the shard sums' reordering).
* ``ucca``, ``project``: rtol 1e-9; ``check``: err rtol 1e-8, mse <
  1e-10.
* a sharded mid-run checkpoint resumed unsharded: eigenvalues rtol 1e-8.
* ``cv_scca`` / ``split_scca`` on 2 shards against their unsharded
  runs: correlations atol 1e-9, the same best cell, folds and flags.
* a streamed sharded ``pca`` / ``check`` against the resident unsharded
  run: eigenvalues rtol 1e-10 (float64, another summation order).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

import flashpca_tpu as fj
from flashpca_tpu.io.plink import write_bed
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.parallel import snp_mesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh4():
    return snp_mesh(["cpu"] * 4)


@pytest.fixture(scope="module")
def jmesh4():
    return JMesh(np.array(jax.devices("cpu")[:4]), ("snps",))


@pytest.fixture(scope="module")
def pheno(small_plink):
    root, geno = small_plink
    rng = np.random.default_rng(23)
    Y = rng.normal(size=(geno.shape[0], 3))
    Y[:, 0] += 0.5 * np.nan_to_num(geno[:, :2]).sum(axis=1)
    return Y


def test_scca_sharded_matches_jax(small_plink, pheno, mesh4, jmesh4):
    root, _ = small_plink
    V0 = np.random.default_rng(4).normal(size=(pheno.shape[1], 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, V0=V0)
    res_m = ft.scca(root, pheno, 1e-3, 1e-3, mesh=mesh4, **kw)
    for ref in (fj.scca(root, pheno, 1e-3, 1e-3, mesh=jmesh4, **kw),
                ft.scca(root, pheno, 1e-3, 1e-3, device="cpu", **kw)):
        assert res_m.converged == ref.converged
        np.testing.assert_allclose(res_m.d, ref.d, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(res_m.U, ref.U, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(res_m.V, ref.V, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(res_m.Px, np.asarray(ref.Px), rtol=1e-7,
                                   atol=1e-9)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_scca_grid_sharded_matches_unsharded(small_plink, pheno, mesh4,
                                             engine):
    """The penalty grid on a mesh, the device engine on the resident
    operator and the host engine on the streamed one."""
    root, _ = small_plink
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, seed=3)
    if engine == "host":
        kw["streaming"] = True
    lam1, lam2 = [1e-3, 0.2], [1e-3, 0.3]
    g = ft.scca_grid(root, pheno, lam1, lam2, mesh=mesh4, **kw)
    ref = ft.scca_grid(root, pheno, lam1, lam2, device="cpu", **kw)
    np.testing.assert_array_equal(g.converged, ref.converged)
    np.testing.assert_array_equal(g.n_iters, ref.n_iters)
    np.testing.assert_allclose(g.d, ref.d, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(g.U, ref.U, rtol=1e-7, atol=1e-9)


def test_ucca_sharded_matches_jax(small_plink, pheno, mesh4, jmesh4):
    root, _ = small_plink
    res_m = ft.ucca(root, pheno, mesh=mesh4)
    np.testing.assert_allclose(res_m.result,
                               fj.ucca(root, pheno, mesh=jmesh4).result,
                               rtol=1e-9, atol=1e-12)


def test_check_sharded_matches_jax(small_plink, mesh4, jmesh4):
    root, _ = small_plink
    res = ft.pca(root, 3, tol=1e-9, device="cpu")
    chk_m = ft.check(root, res.vectors, res.values, mesh=mesh4)
    chk_j = fj.check(root, res.vectors, res.values, mesh=jmesh4)
    np.testing.assert_allclose(chk_m.err, chk_j.err, rtol=1e-8, atol=1e-14)
    assert chk_m.mse < 1e-10


def test_project_sharded_matches_jax(small_plink, mesh4, jmesh4):
    root, _ = small_plink
    res = ft.pca(root, 3, tol=1e-9, do_loadings=True, device="cpu")
    ms = np.column_stack([res.center, res.scale])
    pr_m = ft.project(root, res.loadings, meansd=ms, mesh=mesh4)
    pr_j = fj.project(root, res.loadings, meansd=ms, mesh=jmesh4)
    np.testing.assert_allclose(pr_m.projection, pr_j.projection,
                               rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """tests/test_mesh_modes.py's checkpoint fileset: a clustered
    spectrum that takes several thick restarts at tol 1e-10."""
    rng = np.random.default_rng(31)
    geno = rng.binomial(2, rng.uniform(0.1, 0.5, 152)[None, :],
                        size=(300, 152)).astype(np.float64)
    root = str(tmp_path_factory.mktemp("big") / "big")
    write_bed(root, geno)
    return root


def test_pca_mid_run_checkpoint_sharded(big, mesh4, jmesh4, tmp_path,
                                        monkeypatch):
    """checkpoint_every under a mesh: the mid-run states write from the
    replicated Ritz panel and resume unsharded; the sharded values are
    the JAX package's sharded ones."""
    import flashpca_tpu_torch.solvers.lanczos as lz
    from flashpca_tpu_torch.solvers.lanczos import load_state

    writes = []
    orig = lz.save_state
    monkeypatch.setattr(lz, "save_state",
                        lambda *a: (writes.append(bool(a[4])), orig(*a))[1])
    state = str(tmp_path / "mesh_state.npz")
    res = ft.pca(big, 3, tol=1e-10, mesh=mesh4, state_out=state,
                 checkpoint_every=1)
    assert len(writes) >= 2 and not writes[0]   # mid-run writes fired
    assert bool(load_state(state)["converged"])  # the final write wins
    warm = ft.pca(big, 3, tol=1e-10, state_in=state, device="cpu")
    np.testing.assert_allclose(warm.values, res.values, rtol=1e-8)
    ref = fj.pca(big, 3, tol=1e-10, mesh=jmesh4)
    np.testing.assert_allclose(res.values, ref.values, rtol=1e-8)


def test_scca_mesh_resume_from_unsharded_state(small_plink, pheno, mesh4,
                                               tmp_path):
    """Per-dimension SCCA states written by an unsharded run (of either
    package) resume on a SNP-sharded mesh: the deflation state carries
    no layout."""
    root, _ = small_plink
    V0 = np.random.default_rng(7).normal(size=(pheno.shape[1], 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, V0=V0)
    full = ft.scca(root, pheno, 1e-3, 1e-3, device="cpu", **kw)
    cut = str(tmp_path / "cut.npz")
    # a state after dimension 0: the JAX package's writer, a 1-dim run
    jfull = fj.scca(root, pheno, 1e-3, 1e-3, **kw)
    fj.save_scca_state(cut, np.column_stack([jfull.U[:, 0],
                                             np.zeros(len(jfull.U))]),
                       np.column_stack([jfull.V[:, 0], V0[:, 1]]),
                       np.array([jfull.d[0], 0.0]), 1, V0, 1e-3, 1e-3,
                       divisor="p", stand_x="binom2", stand_y="sd")
    resumed = ft.scca(root, pheno, 1e-3, 1e-3, mesh=mesh4, state_in=cut,
                      **kw)
    assert resumed.converged
    np.testing.assert_allclose(resumed.d, full.d, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(resumed.U, full.U, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(resumed.V, full.V, rtol=1e-7, atol=1e-9)


def _same_search(a, b, fields):
    for f in fields:
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-9,
                                   equal_nan=True, err_msg=f)
    assert (a.best_lambda1, a.best_lambda2) == (b.best_lambda1,
                                                b.best_lambda2)


def test_cv_scca_on_a_mesh_matches_unsharded(small_plink, pheno, tmp_path):
    root, _ = small_plink
    kw = dict(ndim=1, nfolds=3, seed=2, init=True)
    lam = ([1e-3, 0.1], [1e-3, 0.2])
    a = ft.cv_scca(root, pheno, *lam, mesh=snp_mesh(["cpu"] * 2),
                   workdir=str(tmp_path / "wd"), **kw)
    b = ft.cv_scca(root, pheno, *lam, device="cpu", **kw)
    _same_search(a, b, ("corr", "nzero_x", "nzero_y"))
    np.testing.assert_array_equal(a.folds, b.folds)
    np.testing.assert_array_equal(a.converged, b.converged)


def test_split_scca_on_a_mesh_matches_unsharded(small_plink, pheno):
    root, _ = small_plink
    kw = dict(ndim=1, seed=4, prop_train=0.7)
    lam = ([1e-3, 0.1], [1e-3, 0.2])
    a = ft.split_scca(root, pheno, *lam, mesh=snp_mesh(["cpu"] * 2), **kw)
    b = ft.split_scca(root, pheno, *lam, device="cpu", **kw)
    _same_search(a, b, ("corr_train", "corr_test", "nzero_x", "nzero_y"))
    np.testing.assert_array_equal(a.train_idx, b.train_idx)
    np.testing.assert_array_equal(a.converged, b.converged)


@pytest.mark.parametrize("tall", [False, True], ids=["wide", "tall"])
def test_streamed_sharded_pca_matches_resident(big, tall):
    """Each staged block split across 3 shards (each device's buffers
    hold its part), against the resident unsharded run."""
    mesh = snp_mesh(["cpu"] * 3, axis_name="samples" if tall else "snps")
    kw = dict(tol=1e-10, operator_mode="tall" if tall else "wide")
    got = ft.pca(big, 3, streaming=True, memory_mb=1, mesh=mesh, **kw)
    want = ft.pca(big, 3, device="cpu", **kw)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-10)
    if not tall:
        chk = ft.check(big, got.vectors, got.values, mesh=mesh,
                       streaming=True, memory_mb=1)
        assert chk.mse < 1e-10


def test_dense_paths_note_and_ignore_a_mesh(small_plink, pheno, mesh4,
                                            capsys):
    """The matrix paths run unsharded and say so, as the JAX package's."""
    root, geno = small_plink
    X = np.nan_to_num(geno)
    Xi = ft.PlinkDataset.open(root).read_matrix()
    got = ft.pca(root, 2, batch=True, mesh=mesh4, device="cpu")
    np.testing.assert_allclose(
        got.values, ft.pca(Xi, 2, device="cpu", check_geno=False).values,
        rtol=1e-12)
    ft.ucca(X, pheno, mesh=mesh4, device="cpu")
    ft.scca(X, pheno, 1e-3, 1e-3, ndim=1, mesh=mesh4, device="cpu")
    out = capsys.readouterr()
    assert (out.out + out.err).count("runs unsharded") >= 3
