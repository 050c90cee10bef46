"""The port's eigensolvers against the JAX package's, on dense symmetric
problems with no deflation.

Both solvers draw their start panel from numpy ``default_rng(seed)``, so
on a problem where no panel deflates (no random injection: the JAX
solver draws those from its own PRNG, the port from a torch.Generator)
they take the same path: equal ``n_ops`` and ``n_restarts``, and
eigenvalues to 1e-10 relative at float64.  Vectors are compared up to
sign.  Restart checkpoints (.npz) are exchanged both ways.  The start
panel is numpy's QR of that draw, factored where the basis lives, with
no host QR on the path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flashpca_tpu.solvers import block_lanczos as jbl
from flashpca_tpu.solvers import lanczos as jlz
from flashpca_tpu_torch.solvers import block_lanczos as tbl
from flashpca_tpu_torch.solvers import lanczos as tlz

torch.set_num_threads(2)


def _psd(seed, n, m):
    X = np.random.default_rng(seed).standard_normal((n, m))
    return X @ X.T / m


def _vec_err(U, V):
    """Largest sign-invariant column distance."""
    U, V = np.asarray(U, np.float64), np.asarray(V, np.float64)
    return max(min(np.linalg.norm(U[:, j] - V[:, j]),
                   np.linalg.norm(U[:, j] + V[:, j]))
               for j in range(U.shape[1]))


@pytest.mark.parametrize("n,nev,block,seed", [
    (300, 6, 4, 3),
    (240, 4, 8, 7),
    (400, 10, 16, 11),
])
def test_eigsh_block_matches_jax(n, nev, block, seed):
    A = _psd(seed, n, n + 60)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(block=block, maxiter=200, tol=1e-10, seed=seed)
    rj = jbl.eigsh_block(lambda Q: Aj @ Q, n, nev, dtype=jnp.float64, **kw)
    rt = tbl.eigsh_block(lambda Q: At @ Q, n, nev, dtype=torch.float64,
                         device="cpu", **kw)
    assert rt.converged and rj.converged
    assert rt.n_restarts > 1                  # the thick restart is exercised
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.eigenvalues, rj.eigenvalues, rtol=1e-10)
    w = np.linalg.eigvalsh(A)[::-1][:nev]
    np.testing.assert_allclose(rt.eigenvalues, w, rtol=1e-10)
    assert _vec_err(rt.eigenvectors.numpy(), rj.eigenvectors) < 1e-7
    assert np.array_equal(rt.conv_mask, rj.conv_mask)


def test_scalar_fallback_matches_jax():
    # n too small for panels: both fall back to scalar Lanczos
    n, nev = 40, 5
    A = _psd(2, n, 70)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    rj = jbl.eigsh_block(lambda Q: Aj @ Q, n, nev, block=16, tol=1e-10,
                         dtype=jnp.float64, seed=4)
    rt = tbl.eigsh_block(lambda Q: At @ Q, n, nev, block=16, tol=1e-10,
                         dtype=torch.float64, device="cpu", seed=4)
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.eigenvalues, rj.eigenvalues, rtol=1e-10)
    assert _vec_err(rt.eigenvectors.numpy(), rj.eigenvectors) < 1e-7
    rs = tlz.eigsh(lambda v: At @ v, n, nev, tol=1e-10, dtype=torch.float64,
                   device="cpu", seed=4)
    js = jlz.eigsh(lambda v: Aj @ v, n, nev, tol=1e-10, dtype=jnp.float64,
                   seed=4)
    assert rs.n_ops == js.n_ops
    np.testing.assert_allclose(rs.eigenvalues, js.eigenvalues, rtol=1e-10)


@pytest.mark.parametrize("ff", [False, True])
def test_polish_subspace_matches_jax(ff):
    n, k = 256, 5
    rng = np.random.default_rng(1)
    # gapped top spectrum, so two sweeps converge the subspace
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([[10.0, 8.0, 6.0, 5.0, 4.0], rng.uniform(0, 1, n - 5)])
    A = (Q * w) @ Q.T
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    # a rough subspace: the top eigenvectors plus noise
    U0 = Q[:, :k] + 1e-3 * rng.standard_normal((n, k))
    U0, _ = np.linalg.qr(U0)
    kw = {}
    kt = {}
    if ff:
        # an exact two-float "product": the (hi, lo) split of A x
        def jff(x):
            y = Aj @ x
            return y, jnp.zeros_like(y)

        def tff(x):
            y = At @ x
            return y, torch.zeros_like(y)

        kw = dict(ff_gram=jff, return_resid=True)
        kt = dict(ff_gram=tff, return_resid=True)
    oj = jbl.polish_subspace(lambda Q: Aj @ Q, jnp.asarray(U0), iters=2,
                             **kw)
    ot = tbl.polish_subspace(lambda Q: At @ Q, torch.as_tensor(U0), iters=2,
                             **kt)
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-10)
    w = np.linalg.eigvalsh(A)[::-1][:k]
    np.testing.assert_allclose(ot[0], w, rtol=1e-6)
    assert _vec_err(ot[1].numpy(), oj[1]) < 1e-7
    if ff:
        np.testing.assert_allclose(ot[2], oj[2], rtol=1e-3, atol=1e-12)


def test_ritz_small_problems_identical():
    rng = np.random.default_rng(0)
    B = rng.standard_normal((30, 6))
    H = B.T @ np.diag(np.linspace(1, 3, 30)) @ B
    M = B.T @ B
    for fn in ("_ritz_generalized", "_ritz_whitened"):
        tj, sj = getattr(jbl, fn)(H, M)
        tt, st = getattr(tbl, fn)(H, M)
        np.testing.assert_allclose(tt, tj, rtol=1e-12)
        np.testing.assert_allclose(np.abs(st), np.abs(sj), rtol=1e-8,
                                   atol=1e-10)
    # a duplicated basis column makes M singular: both fall back
    Bd = np.column_stack([B, B[:, 0]])
    Hd = Bd.T @ np.diag(np.linspace(1, 3, 30)) @ Bd
    tj, _ = jbl._ritz_generalized(Hd, Bd.T @ Bd)
    tt, _ = tbl._ritz_generalized(Hd, Bd.T @ Bd)
    np.testing.assert_allclose(np.sort(tt)[-6:], np.sort(tj)[-6:],
                               rtol=1e-8)


def test_checkpoints_load_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    vec = rng.standard_normal((50, 3))
    vals, res = np.array([3.0, 2.0, 1.0]), np.array([1e-9, 2e-9, 3e-9])
    jlz.save_state(str(tmp_path / "j.npz"), vec, vals, res, True)
    got = tlz.load_state(str(tmp_path / "j.npz"))
    tlz.save_state(str(tmp_path / "t.npz"), torch.as_tensor(vec), vals, res,
                   False)
    back = jlz.load_state(str(tmp_path / "t.npz"))
    for a, b, conv in ((got, dict(vectors=vec, eigenvalues=vals,
                                  residuals=res), True),
                       (back, dict(vectors=vec, eigenvalues=vals,
                                   residuals=res), False)):
        assert set(a) == {"vectors", "eigenvalues", "residuals", "converged"}
        for key, want in b.items():
            assert a[key].dtype == np.float64
            np.testing.assert_array_equal(a[key], want)
        assert bool(a["converged"]) is conv


def test_eigsh_block_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tbl.eigsh_block(lambda Q: Q, 40, 3, maxiter=0, device="cpu")
    with pytest.raises(ValueError):
        tlz.eigsh(lambda v: v, 40, 0, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_orth_solves_long_panels_in_column_blocks(monkeypatch, dtype):
    """The panel factor is applied in blocks of columns (one long
    solve_triangular is pathologically slow on the card); the blocks
    give the single solve's result and _panel_orth the JAX one's."""
    rng = np.random.default_rng(4)
    W = rng.standard_normal((203, 6))
    G = W.T @ W + 0.1 * np.eye(6)
    L = torch.as_tensor(np.linalg.cholesky(G), dtype=dtype)
    B = torch.as_tensor(W.T, dtype=dtype)
    whole = torch.linalg.solve_triangular(L, B, upper=False)
    monkeypatch.setattr(tbl, "_TRSM_COLS", 7)
    assert torch.equal(tbl._solve_lower(L, B), whole)
    Q, _, good = tbl._panel_orth(torch.as_tensor(W, dtype=dtype), 1e-10)
    Qj, _, _ = jbl._panel_orth(jnp.asarray(W, dtype=jnp.dtype(
        str(dtype).split(".")[1])), 1e-10)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert bool(good.all())
    assert _vec_err(Q.numpy(), np.asarray(Qj)) < tol


@pytest.mark.parametrize("v0", [None, "vector", "panel"])
def test_start_basis_is_the_host_qr_of_the_same_draw(v0):
    """The start panel is factored where the basis lives, and is the
    numpy (LAPACK) QR of the same seeded draw column for column: the
    same Householder signs, so the solve starts where the JAX one
    does."""
    n, b, seed = 1003, 16, 21
    rng = np.random.default_rng(5)
    w = {None: None, "vector": rng.standard_normal(n),
         "panel": rng.standard_normal((n, 5))}[v0]
    draw = np.random.default_rng(seed).standard_normal((n, b))
    if v0 == "vector":
        draw[:, 0] = w
    elif v0 == "panel":
        draw[:, :5] = w
    want, _ = np.linalg.qr(draw)
    V = tbl._start_basis(n, 3 * b, b, seed, w, torch.float64, "cpu")
    assert V.shape == (n, 3 * b) and V.dtype == torch.float64
    got = V[:, :b].numpy()
    assert np.abs(got - want).max() <= 1e-12
    assert np.abs(got.T @ got - np.eye(b)).max() <= 1e-13
    assert not bool(V[:, b:].any())
    # the basis' own dtype holds the float64 factor rounded once
    V32 = tbl._start_basis(n, 2 * b, b, seed, w, torch.float32, "cpu")
    assert V32.dtype == torch.float32
    np.testing.assert_allclose(V32[:, :b].numpy(), want, rtol=0, atol=1e-7)


def test_eigsh_block_start_takes_no_host_qr(monkeypatch):
    """No host LAPACK QR on the solve's path: with numpy's refused the
    block solver still converges to the dense spectrum."""
    def refuse(*args, **kwargs):
        raise AssertionError("host QR on the block solver's path")

    monkeypatch.setattr(np.linalg, "qr", refuse)
    n, nev = 300, 6
    A = _psd(3, n, n + 60)
    At = torch.as_tensor(A)
    rt = tbl.eigsh_block(lambda Q: At @ Q, n, nev, block=4, maxiter=200,
                         tol=1e-10, seed=3, dtype=torch.float64,
                         device="cpu")
    assert rt.converged
    np.testing.assert_allclose(rt.eigenvalues,
                               np.linalg.eigvalsh(A)[::-1][:nev],
                               rtol=1e-10)
