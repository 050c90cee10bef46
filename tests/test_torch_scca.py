"""The port's ``scca()``, SCCA checkpoints and the CLI's ``--scca``
against the JAX package's (``scca_grid``: test_torch_scca_grid.py).

Inputs (numpy, seeded): a 120 x 60 genotype matrix with 8 phenotypes,
one of them carrying three SNPs' effect (seed 2042, the JAX test's); PLINK
filesets of 60-63 samples (every n % 4) x 37 SNPs with 5% missing calls
and one constant SNP, and the suite's ``small_plink``.

Tolerances:

* float64 (the CPU path against the JAX package at x64): ``d`` rtol
  1e-9, U, V, Px and Py atol 1e-10;
* float32 (an operator with ``use_kernels=True``, the plain versions of
  B1 and B2, against the JAX operator at float32 on its jnp path, both
  engines at tol 1e-5): ``d`` rtol 1e-5, U and V atol 1e-4 (each
  package's float32 rounding in a penalized fixed point that tol 1e-5
  stops within about 1e-5 of);
* streamed against resident at float64: rtol 1e-9 / atol 1e-10;
* the CLI: byte for byte (tests/golden/scca and the JAX CLI's files).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.cli import main as jmain
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.models.scca import load_scca_state as jload_state
from flashpca_tpu.models.scca import norm_thresh as jnorm_thresh
from flashpca_tpu.models.scca import scca as jscca
from flashpca_tpu.models.scca import soft_thresh as jsoft_thresh
from flashpca_tpu.ops.operator import PackedOperator as JPackedOperator
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.models.scca import make_gaussian
from flashpca_tpu_torch.ops.operator import packed_operator_from_numpy
from flashpca_tpu_torch.ops.standardize import standardize
from flashpca_tpu_torch.parallel import snp_mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "scca")
# models/__init__ binds the name ``scca`` to the function
tscca_mod = sys.modules["flashpca_tpu_torch.models.scca"]

F64 = dict(rtol=1e-9, atol=1e-10)


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(2042)
    n, p, k = 120, 60, 8
    X = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    Y = rng.normal(size=(n, k))
    Y[:, 0] += 0.4 * X[:, :3].sum(axis=1)
    return X, Y


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    """PLINK filesets of n = 60..63 samples (every n % 4) and their
    phenotypes, keyed by n % 4."""
    out = {}
    base = tmp_path_factory.mktemp("scca")
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


def _same(got, want, **tol):
    """Two SCCAResults equal at ``tol`` (F64 by default)."""
    tol = tol or F64
    assert got.converged == want.converged
    np.testing.assert_allclose(got.d, want.d, rtol=tol["rtol"],
                               atol=tol["atol"])
    for key in ("U", "V", "Px", "Py", "V0"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   atol=tol["atol"], err_msg=key)


# ---------------------------------------------------------------------------
# helpers and the operator's pure products
# ---------------------------------------------------------------------------

def test_soft_and_norm_thresh_match_jax():
    a = np.array([3.0, -2.0, 0.5, -0.1, 0.0])
    np.testing.assert_array_equal(ft.soft_thresh(a, 1.0),
                                  jsoft_thresh(a, 1.0))
    np.testing.assert_allclose(ft.soft_thresh(a, 1.0),
                               [2.0, -1.0, 0.0, 0.0, 0.0])
    x = np.array([3.0, 4.0, 0.1])
    y = ft.norm_thresh(x.copy(), 0.1)
    np.testing.assert_allclose(np.linalg.norm(y), 1.0)
    np.testing.assert_array_equal(y, jnorm_thresh(x.copy(), 0.1))
    # a zero vector, and one the threshold zeroes, stay finite zeros
    for z in (np.zeros(4), np.array([0.1, -0.1, 0.1, 0.1])):
        np.testing.assert_array_equal(ft.norm_thresh(z, 0.9), np.zeros(4))


@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
def test_products_pure_on_every_n_mod_4(filesets, nmod):
    """The device engine's products, ``_cross_p`` / ``_mv_p`` (what the
    JAX operator's ``products_pure`` returns), are X^T x and X v in
    permuted space, with the byte-padding rows of ``_mv_p``'s output zero
    and garbage on ``_cross_p``'s padding rows ignored."""
    root, _, _ = filesets[nmod]
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    op = ft.PackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                           device="cpu")
    rng = np.random.default_rng(nmod)
    x = rng.normal(size=(ds.n_samples, 3))
    v = rng.normal(size=(ds.n_snps, 3))
    xp = op.permute(x)
    pad = op._valid == 0
    assert int(pad.sum()) == op.n4 - ds.n_samples
    xp[pad] = 1e3                                  # garbage on padding
    z = op._cross_p(xp)
    np.testing.assert_allclose(z.numpy(), op.crossprod(x).numpy(),
                               rtol=1e-12, atol=1e-12)
    y = op._mv_p(torch.as_tensor(v))
    assert torch.all(y[pad] == 0)
    np.testing.assert_allclose(op.unpermute(y).numpy(), op.prod(v).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert op.nops == 2                            # the public ones only


# ---------------------------------------------------------------------------
# scca() against the JAX package
# ---------------------------------------------------------------------------

def test_self_scca_recovers_eigenvalues(xy):
    """SCCA of X with itself at tiny penalties ~ SVD of X'X/(n-1)
    (flashpcaR test_scca.R:32-49), as the JAX package's."""
    X, _ = xy
    n, ndim = X.shape[0], 3
    Xs, _, _ = standardize(X, "binom2")
    V0 = np.random.default_rng(5).normal(size=(X.shape[1], ndim))
    kw = dict(ndim=ndim, stand_x="binom2", stand_y="binom2", divisor="n1",
              maxiter=2000, tol=1e-10, V0=V0)
    res = ft.scca(X, X, 1e-9, 1e-9, device="cpu", **kw)
    assert res.converged
    ev = np.linalg.eigvalsh(Xs.T @ Xs / (n - 1))[::-1][:ndim]
    np.testing.assert_allclose(np.sort(res.d)[::-1], ev, rtol=1e-4)
    _same(res, jscca(X, X, 1e-9, 1e-9, **kw))


@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
def test_scca_plink_matches_jax_and_matrix(filesets, nmod):
    """The packed path on every n % 4 against the JAX package's, and
    against the port's matrix path on the same standardized matrix."""
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    root, _, Y = filesets[nmod]
    V0 = np.random.default_rng(nmod).normal(size=(4, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-8, V0=V0)
    res = ft.scca(root, Y, 1e-3, 1e-3, device="cpu", **kw)
    assert res.converged
    _same(res, jscca(root, Y, 1e-3, 1e-3, **kw))
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    W = dense_standardized_np(ds.read_codes(), mean, sd)
    res_mx = ft.scca(W.T, Y, 1e-3, 1e-3, stand_x="none", device="cpu", **kw)
    np.testing.assert_allclose(res.d, res_mx.d, rtol=1e-6)
    np.testing.assert_allclose(res.U, res_mx.U, atol=1e-7)
    np.testing.assert_allclose(res.V, res_mx.V, atol=1e-7)


def test_scca_divisor_relation(xy):
    """d_n1 == d_none / (n-1) (flashpcaR test_scca.R:114-155); each
    divisor as the JAX package's."""
    X, Y = xy
    V0 = np.random.default_rng(6).normal(size=(Y.shape[1], 2))
    kw = dict(ndim=2, maxiter=2000, tol=1e-9, V0=V0)
    r = {}
    for div in ("none", "n1"):
        r[div] = ft.scca(X, Y, 1e-6, 1e-6, divisor=div, device="cpu", **kw)
        assert r[div].converged
        _same(r[div], jscca(X, Y, 1e-6, 1e-6, divisor=div, **kw))
    np.testing.assert_allclose(r["n1"].d, r["none"].d / (X.shape[0] - 1),
                               rtol=1e-4)


def test_scca_v0_determinism_and_jax_seed(xy):
    X, Y = xy
    r1 = ft.scca(X, Y, 1e-3, 1e-3, ndim=2, seed=7, maxiter=500, tol=1e-7,
                 device="cpu")
    r2 = ft.scca(X, Y, 1e-3, 1e-3, ndim=2, seed=7, maxiter=500, tol=1e-7,
                 device="cpu")
    np.testing.assert_array_equal(r1.d, r2.d)
    np.testing.assert_array_equal(r1.V0, r2.V0)
    # the same seed draws the same V0 as the JAX package
    want = jscca(X, Y, 1e-3, 1e-3, ndim=2, seed=7, maxiter=500, tol=1e-7)
    np.testing.assert_array_equal(r1.V0, want.V0)
    np.testing.assert_array_equal(make_gaussian(8, 2, 7), want.V0)
    _same(r1, want)


def test_scca_sparsity_increases_with_penalty(xy):
    X, Y = xy
    V0 = np.random.default_rng(3).normal(size=(Y.shape[1], 1))
    kw = dict(ndim=1, maxiter=1000, tol=1e-8, V0=V0)
    lo = ft.scca(X, Y, 1e-6, 1e-6, device="cpu", **kw)
    hi = ft.scca(X, Y, 0.15, 1e-6, device="cpu", **kw)
    assert np.count_nonzero(hi.U) < np.count_nonzero(lo.U)
    _same(hi, jscca(X, Y, 0.15, 1e-6, **kw))


@pytest.mark.parametrize("engine", ["device", "host"])
def test_scca_too_large_penalty_aborts(xy, engine):
    X, Y = xy
    kw = dict(ndim=2, maxiter=100, tol=1e-6, engine=engine)
    res = ft.scca(X, Y, 10.0, 10.0, device="cpu", **kw)
    assert not res.converged
    assert np.all(np.isfinite(res.U)) and np.all(np.isfinite(res.V))
    _same(res, jscca(X, Y, 10.0, 10.0, **kw))


def test_scca_px_py(xy):
    X, Y = xy
    V0 = np.random.default_rng(4).normal(size=(Y.shape[1], 2))
    res = ft.scca(X, Y, 1e-4, 1e-4, ndim=2, maxiter=1000, tol=1e-8, V0=V0,
                  device="cpu")
    Xs, _, _ = standardize(X, "binom2")
    Ys, _, _ = standardize(Y, "sd")
    np.testing.assert_allclose(res.Px, Xs @ res.U, atol=1e-7)
    np.testing.assert_allclose(res.Py, Ys @ res.V, atol=1e-7)


def test_scca_auto_init_deterministic():
    rng = np.random.default_rng(31)
    n, p, k = 80, 25, 3
    X = rng.standard_normal((n, p))
    Y = X[:, :k] + 0.1 * rng.standard_normal((n, k))
    kw = dict(ndim=2, stand_x="sd", auto_init=True, seed=3, maxiter=300,
              tol=1e-6)
    r1 = ft.scca(X, Y, 1e-3, 1e-3, device="cpu", **kw)
    r2 = ft.scca(X, Y, 1e-3, 1e-3, device="cpu", **kw)
    np.testing.assert_array_equal(r1.d, r2.d)
    np.testing.assert_array_equal(r1.U, r2.U)
    _same(r1, jscca(X, Y, 1e-3, 1e-3, **kw))


def test_scca_accepts_prebuilt_operators(small_plink):
    root, geno = small_plink
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    op = ft.PackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                           device="cpu")
    rng = np.random.default_rng(9)
    Y = rng.normal(size=(ds.n_samples, 3))
    V0 = rng.normal(size=(3, 2))
    kw = dict(ndim=2, maxiter=800, tol=1e-9, V0=V0)
    res_op = ft.scca(op, Y, 1e-3, 1e-3, **kw)
    res_ds = ft.scca(root, Y, 1e-3, 1e-3, device="cpu", **kw)
    _same(res_op, res_ds)
    jop = JPackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                          dtype=jnp.float64)
    _same(res_op, jscca(jop, Y, 1e-3, 1e-3, **kw))
    # a prebuilt DenseOperator as the JAX one
    X_std, _, _ = standardize(geno, "binom2")
    dres = ft.scca(ft.DenseOperator(X_std, device="cpu"), Y, 1e-3, 1e-3,
                   **kw)
    _same(dres, jscca(fj.DenseOperator(X_std, dtype=jnp.float64), Y, 1e-3,
                      1e-3, **kw))


def _pheno(n, seed=17):
    return np.random.default_rng(seed).normal(size=(n, 4))


def test_scca_streaming_matches_resident(small_plink):
    root, geno = small_plink
    Y = _pheno(geno.shape[0])
    Y[:, 0] += 0.5 * np.nan_to_num(geno[:, :3]).sum(axis=1)
    V0 = np.random.default_rng(2).normal(size=(4, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, V0=V0)
    res_r = ft.scca(root, Y, 1e-3, 1e-3, streaming=False, device="cpu",
                    **kw)
    res_s = ft.scca(root, Y, 1e-3, 1e-3, streaming=True, memory_mb=1,
                    device="cpu", **kw)
    _same(res_s, res_r)
    _same(res_s, jscca(root, Y, 1e-3, 1e-3, streaming=True, memory_mb=1,
                       **kw))


def test_scca_host_engine_matches_device(small_plink):
    root, geno = small_plink
    Y = _pheno(geno.shape[0])
    V0 = np.random.default_rng(3).normal(size=(4, 2))
    kw = dict(ndim=2, maxiter=1000, tol=1e-9, V0=V0, streaming=False)
    res_d = ft.scca(root, Y, 2e-3, 1e-3, engine="device", device="cpu",
                    **kw)
    res_h = ft.scca(root, Y, 2e-3, 1e-3, engine="host", device="cpu", **kw)
    _same(res_h, res_d, rtol=1e-7, atol=1e-8)
    np.testing.assert_array_equal(res_h.n_iters, res_d.n_iters)
    assert (res_d.n_iters > 1).all()
    _same(res_h, jscca(root, Y, 2e-3, 1e-3, engine="host", **kw))


def test_scca_refusals(small_plink, xy):
    """The JAX package's refusals with its messages, and the port's own:
    a tall operator, a mesh= that conflicts with device=, a missing
    GPU."""
    root, geno = small_plink
    n = geno.shape[0]
    Y = _pheno(n)
    with pytest.raises(ValueError, match="engine"):
        ft.scca(root, Y, 1e-3, 1e-3, ndim=2, streaming=True,
                engine="device", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        ft.scca(root, Y, 1e-3, 1e-3, ndim=2, engine="gpu", device="cpu")
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    op32 = ft.PackedOperator(ds.read_packed(), mean, sd, n, device="cpu",
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        ft.scca(op32, Y, 1e-3, 1e-3, ndim=2, dtype=torch.float64)
    X, Yx = xy
    for kw in (dict(streaming=True), dict(memory_mb=64)):
        with pytest.raises(ValueError, match="streaming"):
            ft.scca(X, Yx, 1e-3, 1e-3, ndim=2, stand_x="sd", device="cpu",
                    **kw)
    with pytest.raises(ValueError, match="only 4 allowed"):
        ft.scca(root, Y, 1e-3, 1e-3, ndim=5, device="cpu")
    with pytest.raises(ValueError, match="Y rows"):
        ft.scca(root, Y[:-1], 1e-3, 1e-3, ndim=2, device="cpu")
    with pytest.raises(ValueError, match="V0 must be"):
        ft.scca(root, Y, 1e-3, 1e-3, ndim=2, V0=np.zeros((4, 3)),
                device="cpu")
    top = ft.TallPackedOperator(ds.read_packed(), mean, sd, n, device="cpu")
    for fn in (ft.scca, ft.scca_grid):
        args = (1e-3, 1e-3) if fn is ft.scca else ([1e-3], [1e-3])
        with pytest.raises(ValueError, match="tall operator"):
            fn(top, Y, *args, ndim=2)
        # mesh= runs (A18): a CPU mesh conflicting with device= raises
        with pytest.raises(ValueError, match="conflicts with the mesh"):
            fn(root, Y, *args, ndim=2, device="cuda",
               mesh=snp_mesh(["cpu"] * 2))


def test_scca_raises_without_gpu(small_plink, monkeypatch):
    root, geno = small_plink
    Y = _pheno(geno.shape[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for X in (root, np.nan_to_num(geno)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ft.scca(X, Y, 1e-3, 1e-3, ndim=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ft.scca_grid(X, Y, [1e-3], [1e-3], ndim=2)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_scca_float32_through_kernel_wrappers_matches_jax(small_plink,
                                                          engine):
    """A float32 operator with ``use_kernels=True`` (B1's and B2's plain
    versions on the CPU): the device engine runs in float32 and the host
    engine in float64 around float32 products, each against its JAX
    twin on the JAX float32 operator."""
    root, geno = small_plink
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    n = ds.n_samples
    Y = _pheno(n, 23)
    Y[:, 1] += 0.7 * np.nan_to_num(geno[:, 7:10]).sum(axis=1)
    V0 = np.random.default_rng(11).normal(size=(4, 2))
    kw = dict(ndim=2, maxiter=2000, tol=1e-5, V0=V0, engine=engine)
    op = packed_operator_from_numpy(ds.read_packed(), mean, sd, n,
                                    device="cpu", dtype=torch.float32,
                                    use_kernels=True)
    tpk.reset_launch_counts()
    got = ft.scca(op, Y, 2e-3, 1e-3, **kw)
    assert set(tpk.launch_counts.values()) == {0}   # plain on the CPU
    jop = JPackedOperator(ds.read_packed(), mean, sd, n, dtype=jnp.float32,
                          use_pallas=False)
    want = jscca(jop, Y, 2e-3, 1e-3, **kw)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.d, want.d, rtol=1e-5)
    np.testing.assert_allclose(got.U, want.U, atol=1e-4)
    np.testing.assert_allclose(got.V, want.V, atol=1e-4)
    # and against the float64 run of the same engine
    r64 = ft.scca(root, Y, 2e-3, 1e-3, device="cpu", **kw)
    np.testing.assert_allclose(got.d, r64.d, rtol=1e-5)
    np.testing.assert_allclose(got.U, r64.U, atol=1e-4)


# ---------------------------------------------------------------------------
# per-dimension checkpoints (A17's SCCA half)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["device", "host"])
def test_scca_dim_checkpoint_resume(xy, tmp_path, engine):
    """state_out persists after EVERY completed dimension; resuming from
    an early snapshot reproduces the uninterrupted run; every guard
    refuses with the JAX package's message; a state without the
    identity keys still resumes."""
    X, Y = xy
    V0 = np.random.default_rng(12).normal(size=(Y.shape[1], 3))
    kw = dict(ndim=3, maxiter=2000, tol=1e-9, V0=V0, engine=engine,
              device="cpu")
    state = str(tmp_path / f"scca_{engine}.npz")
    snaps = []
    orig = tscca_mod.save_scca_state

    def spy(path, U, V, d, next_dim, V0_, l1, l2, **ident):
        snaps.append(int(next_dim))
        orig(str(tmp_path / f"snap{next_dim}.npz"), U, V, d, next_dim,
             V0_, l1, l2, **ident)
        return orig(path, U, V, d, next_dim, V0_, l1, l2, **ident)

    tscca_mod.save_scca_state = spy
    try:
        full = ft.scca(X, Y, 2e-3, 1e-3, state_out=state, **kw)
    finally:
        tscca_mod.save_scca_state = orig
    assert full.converged and snaps == [1, 2, 3]
    st = ft.load_scca_state(state)
    assert int(st["next_dim"]) == 3
    assert {str(st[key]) for key in ("divisor", "stand_x", "stand_y")} == {
        "p", "binom2", "sd"}
    resumed = ft.scca(X, Y, 2e-3, 1e-3,
                      state_in=str(tmp_path / "snap1.npz"), **kw)
    _same(resumed, full, rtol=1e-10, atol=1e-11)
    done = ft.scca(X, Y, 2e-3, 1e-3, state_in=state, **kw)
    _same(done, full, rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError, match="different penalties"):
        ft.scca(X, Y, 5e-3, 1e-3, state_in=state, **kw)
    bad = dict(kw, V0=np.random.default_rng(13).normal(size=(8, 3)))
    with pytest.raises(ValueError, match="V0 differs"):
        ft.scca(X, Y, 2e-3, 1e-3, state_in=state, **bad)
    with pytest.raises(ValueError, match="divisor"):
        ft.scca(X, Y, 2e-3, 1e-3, state_in=state, divisor="none", **kw)
    with pytest.raises(ValueError, match="stand_y"):
        ft.scca(X, Y, 2e-3, 1e-3, state_in=state, stand_y="center", **kw)
    with pytest.raises(ValueError, match="SCCA state has U"):
        ft.scca(X, Y[:, :5], 2e-3, 1e-3, state_in=state,
                **dict(kw, V0=None))
    legacy = {key: val for key, val in st.items()
              if key not in ("divisor", "stand_x", "stand_y")}
    legacy_path = str(tmp_path / "legacy.npz")
    np.savez(legacy_path, **legacy)
    _same(ft.scca(X, Y, 2e-3, 1e-3, state_in=legacy_path, **kw), full,
          rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_scca_state_resumes_across_packages(xy, tmp_path, direction):
    """A state written after dimension 1 by one package resumes in the
    other to the other's uninterrupted run (the same keys and dtypes)."""
    X, Y = xy
    V0 = np.random.default_rng(14).normal(size=(Y.shape[1], 3))
    kw = dict(ndim=3, maxiter=2000, tol=1e-9, V0=V0)
    state = str(tmp_path / "one.npz")
    writer, reader = ((jscca, lambda *a, **k: ft.scca(*a, device="cpu", **k))
                      if direction == "jax_to_port" else
                      (lambda *a, **k: ft.scca(*a, device="cpu", **k), jscca))
    # a one-dimension run writes the state after dimension 1
    writer(X, Y, 2e-3, 1e-3, state_out=state,
           **dict(kw, ndim=1, V0=V0[:, :1]))
    st = jload_state(state) if direction == "port_to_jax" else \
        ft.load_scca_state(state)
    assert int(st["next_dim"]) == 1 and st["U"].dtype == np.float64
    # widen the one-dimension state to the three-dimension problem
    full = reader(X, Y, 2e-3, 1e-3, **kw)
    st3 = dict(st, U=np.concatenate([st["U"], np.zeros((60, 2))], axis=1),
               V=np.concatenate([st["V"], V0[:, 1:]], axis=1),
               d=np.concatenate([st["d"], np.zeros(2)]), V0=V0)
    np.savez(str(tmp_path / "three.npz"), **st3)
    resumed = reader(X, Y, 2e-3, 1e-3, state_in=str(tmp_path / "three.npz"),
                     **kw)
    _same(resumed, full, rtol=1e-9, atol=1e-10)


# ---------------------------------------------------------------------------
# the CLI's --scca
# ---------------------------------------------------------------------------

def _pheno_file(root, n, path, seed=7, k=3):
    Y = np.random.default_rng(seed).standard_normal((n, k))
    fam = np.loadtxt(root + ".fam", dtype=str)
    with open(path, "w") as fh:
        for i in range(n):
            vals = "\t".join(f"{v:.10g}" for v in Y[i])
            fh.write(f"{fam[i, 0]}\t{fam[i, 1]}\t{vals}\n")
    return Y


def _run_in(main, args, where):
    cwd = os.getcwd()
    os.chdir(where)
    try:
        return main(args)
    finally:
        os.chdir(cwd)


def test_cli_scca_reproduces_golden(small_plink, tmp_path):
    """regen.py's arguments on the same fileset: every file byte for
    byte."""
    root, geno = small_plink
    pheno = str(tmp_path / "pheno.txt")
    _pheno_file(root, geno.shape[0], pheno)
    out = tmp_path / "out"
    out.mkdir()
    assert _run_in(tmain, ["--bfile", root, "--scca", "--pheno", pheno,
                           "--ndim", "2", "--lambda1", "1e-3", "--lambda2",
                           "1e-3", "--tol", "1e-7", "--seed", "1",
                           "--device", "cpu"], out) == 0
    for fn in sorted(os.listdir(GOLDEN)):
        with open(os.path.join(GOLDEN, fn), "rb") as fh:
            assert (out / fn).read_bytes() == fh.read(), fn


def test_cli_scca_extras_match_jax_cli(small_plink, tmp_path):
    """--save-vinit, --outmeansd, --standy, --div n1 and --stream on:
    the same files, byte for byte, as the JAX CLI's."""
    root, geno = small_plink
    pheno = str(tmp_path / "pheno.txt")
    _pheno_file(root, geno.shape[0], pheno, seed=8, k=4)
    args = ["--bfile", root, "--scca", "--pheno", pheno, "--ndim", "2",
            "--lambda1", "2e-3", "--lambda2", "1e-3", "--tol", "1e-8",
            "--save-vinit", "--outmeansd", "ms.txt", "--standy", "center",
            "--div", "n1", "--stream", "on", "--blocksize", "8", "--notime"]
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    assert _run_in(jmain, args, jd) == 0
    assert _run_in(tmain, args + ["--device", "cpu"], td) == 0
    outs = sorted(os.listdir(jd))
    assert "scca_v0.txt" in outs and "ms.txt" in outs
    assert outs == sorted(os.listdir(td))
    for fn in outs:
        assert (td / fn).read_bytes() == (jd / fn).read_bytes(), fn


def test_cli_scca_outstate_instate_round_trip(small_plink, tmp_path):
    root, geno = small_plink
    pheno = str(tmp_path / "pheno.txt")
    _pheno_file(root, geno.shape[0], pheno)
    state = str(tmp_path / "scca_state.npz")
    base = ["--scca", "--bfile", root, "--pheno", pheno, "--ndim", "2",
            "--tol", "1e-8", "--notime", "--device", "cpu"]
    a, b, c = (tmp_path / d for d in ("a", "b", "c"))
    for d in (a, b, c):
        d.mkdir()
    assert _run_in(tmain, base + ["--outstate", state], a) == 0
    assert int(ft.load_scca_state(state)["next_dim"]) == 2
    # a state cut after dimension 1 resumes to the uninterrupted files
    st = ft.load_scca_state(state)
    st.update(next_dim=np.asarray(1), d=np.asarray([st["d"][0], 0.0]))
    st["U"][:, 1] = 0.0
    st["V"][:, 1] = st["V0"][:, 1]
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **st)
    assert _run_in(tmain, base + ["--instate", cut], b) == 0
    # the JAX CLI resumes the port's state too
    assert _run_in(jmain, base[:-2] + ["--instate", cut], c) == 0
    for fn in ("eigenvalues.txt", "eigenvectorsX.txt", "eigenvectorsY.txt",
               "pcsX.txt", "pcsY.txt"):
        assert (b / fn).read_bytes() == (a / fn).read_bytes(), fn
        assert (c / fn).read_bytes() == (a / fn).read_bytes(), fn


def test_cli_scca_refusals_match_jax(small_plink, tmp_path, capsys):
    root, geno = small_plink
    pheno = str(tmp_path / "pheno.txt")
    _pheno_file(root, geno.shape[0], pheno)
    cases = [
        (["--pheno", pheno, "--checkpoint-every", "2", "--outstate",
          "s.npz"], "SCCA persists per completed dimension with --outstate"),
        ([], "you must specify a phenotype file"),
    ]
    for extra, text in cases:
        jd, td = tmp_path / "j", tmp_path / "t"
        for d in (jd, td):
            d.mkdir(exist_ok=True)
        args = ["--bfile", root, "--scca", "--notime"] + extra
        assert _run_in(jmain, args, jd) == 1
        assert _run_in(tmain, args + ["--device", "cpu"], td) == 1
        err = capsys.readouterr().err
        assert err.count(text) == 2, err
        assert not os.listdir(td)
    # --outstate is refused outside PCA and SCCA, with the JAX text
    assert _run_in(tmain, ["--bfile", root, "--ucca", "--pheno", pheno,
                           "--outstate", "s.npz", "--device", "cpu"],
                   tmp_path) == 1
    assert "apply to PCA and SCCA modes only" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# chip_smoke.py's SCCA phases rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_scca_phases_on_the_cpu(monkeypatch):
    """chip_smoke.scca_headline and streamed_scca at 2,003 x 700 on the
    CPU, float32 operators with ``use_kernels=True`` (the kernels' plain
    versions) in place of the card's, no launches to require: the solo
    run converges with every d > 0 at its float64 fixed point, the grid's
    cell 9 holds the solo run, the streamed host engine holds the
    resident device engine, and the streamed grid of 16 cells stages the
    block passes of one solo run, less its Px pass (two blocks of 350
    SNPs)."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    n, p = 2003, 700
    packed, mean, sd, sumsq = cs.card_data(torch.device("cpu"), n, p, 7)
    f32 = dict(device="cpu", dtype=torch.float32, use_kernels=True)
    op = ft.PackedOperator(packed, mean, sd, n, snp_sumsq=sumsq, **f32)
    twins, out = cs.scca_headline(op)
    assert all(x > 0 for x in out["d"]) and len(out["iters"]) == 3
    fp = out["fixed_point"]
    assert max(fp["du"] + fp["dv"]) <= cs.SCCA_FIXED_BAR
    assert max(fp["d_rel"]) <= cs.SCCA_D_BAR
    assert out["grid"]["cell_uv_abs"] <= cs.SCCA_GRID_UV_BAR
    assert np.array(out["grid"]["n_iters"]).shape == (3, 16)
    assert twins["twin"].n_iters.tolist() == [cs.SCCA_TWIN_ITERS]
    sop = ft.StreamingPackedOperator(op.packed.numpy(), op.center, op.scale,
                                     n, block_snps=350, cache_mb=0, **f32)
    assert sop.n_blocks == 2
    s = cs.streamed_scca(sop, twins)
    assert s["twin"]["uv_abs_vs_resident"] <= cs.SCCA_STREAM_BAR
    grid = s["grid"]
    # two passes a step; no d pass for cells that did not converge; the
    # solo run's Px pass besides
    iters = cs.SCCA_STREAM_GRID_ITERS
    assert grid["grid"]["passes"] == 2 * iters
    assert grid["solo"]["passes"] == 2 * iters + 1
    assert (grid["grid"]["staged_blocks"] * (2 * iters + 1)
            == grid["solo"]["staged_blocks"] * 2 * iters)


def test_smoke_scca_rows(monkeypatch):
    """chip_smoke.scca_rows: B1 and B2 timed on one column (their
    one-column kernels) and, where the solo runs launched it, B2 at kc 8
    on their ndim columns (Px = X U), with the solo runs' launches; and
    the grid's rows copied from the kc 16 ones (the current designs) with
    the grid's launches, the streamed launch medians of the copied rows
    dropped."""
    cs = _chip_smoke()
    widths = []

    def timed(op, w, launches, worst, slices):
        widths.append(w)
        return [{"name": nm, "k": k, "launches": launches[nm]}
                for nm, k in w]

    monkeypatch.setattr(cs, "time_kernels", timed)
    base = [{"name": nm, "k": k, "path": "streaming", "ms": 1.0,
             "stream_launch_ms": 2.0}
            for nm in ("crossprod", "matvec", "crossprod_ff")
            for k in (16, 24)]
    rows = cs.scca_rows(None, {"crossprod_narrow": 24, "matvec_narrow": 28,
                               "matvec": 0},
                        {"crossprod": 41, "matvec": 44}, base,
                        "_streaming", slices=4)
    assert widths == [[("crossprod_narrow", 1), ("matvec_narrow", 1)]]
    assert [(r["name"], r["k"], r["path"], r["launches"]) for r in rows] == [
        ("crossprod_narrow", 1, "scca_streaming", 24),
        ("matvec_narrow", 1, "scca_streaming", 28),
        ("crossprod", 16, "scca_grid_streaming", 41),
        ("matvec", 16, "scca_grid_streaming", 44)]
    assert all("stream_launch_ms" not in r for r in rows)
    assert rows[2]["ms"] == 1.0 and base[0]["path"] == "streaming"
    # a solo fit of 3 dimensions: its Px on B2 at kc 8
    widths.clear()
    rows = cs.scca_rows(None, {"crossprod_narrow": 30, "matvec_narrow": 33,
                               "matvec": 1}, {}, [], "", slices=32, ndim=3)
    assert widths == [[("crossprod_narrow", 1), ("matvec_narrow", 1),
                       ("matvec", 3)]]
    assert [(r["name"], r["k"], r["path"], r["launches"]) for r in rows] == [
        ("crossprod_narrow", 1, "scca", 30), ("matvec_narrow", 1, "scca", 33),
        ("matvec", 3, "scca", 1)]
