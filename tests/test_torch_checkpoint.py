"""Mid-run checkpoints (``checkpoint_every``) of the port's ``pca()`` and
CLI against the JAX package's, mirroring tests/test_checkpoint.py.

Checkpoints keep the JAX package's .npz format, so a mid-run checkpoint
written by either package resumes in the other.  Problems: a 300 x 250
matrix of unstructured random genotypes (~40 thick restarts at k=8,
tol=1e-10 in float64, as tests/test_checkpoint.py's), and the 61 x 37
toy fileset.

Tolerances: resumed eigenvalues rtol 1e-9 against the cold run at
float64 (both solves converge to tol 1e-10); resumed across packages
rtol 1e-8 and sign-invariant vectors within 1e-7 of 1 in |cos|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
import flashpca_tpu.solvers.lanczos as jlz
from flashpca_tpu.cli import main as jmain
import flashpca_tpu_torch as ft
import flashpca_tpu_torch.solvers.lanczos as tlz
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.ops.standardize import standardize
from flashpca_tpu_torch.solvers.block_lanczos import eigsh_block

torch.set_num_threads(2)


def _slow_problem(n=300, p=250, seed=3):
    rng = np.random.default_rng(seed)
    return rng.binomial(
        2, rng.uniform(0.1, 0.5, p)[None, :], size=(n, p)).astype(float)


def _spy(monkeypatch, module):
    """Record every save_state call of ``module``: (rows, columns,
    converged), and keep a copy of the first mid-run write's arrays."""
    calls, first = [], {}
    orig = module.save_state

    def spy(path, vectors, values, residuals, converged):
        v = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                       else vectors, dtype=np.float64)
        calls.append((v.shape, bool(converged)))
        if not converged and not first:
            first.update(vectors=v, values=np.asarray(values),
                         residuals=np.asarray(residuals))
        return orig(path, vectors, values, residuals, converged)

    monkeypatch.setattr(module, "save_state", spy)
    return calls, first


def test_mid_run_checkpoints_fire_and_resume(tmp_path):
    """The solver hands out the current Ritz panel after every R-th
    restart; a state saved from the FIRST (least converged) snapshot
    warm-starts a resume in fewer restarts to the same eigenpairs."""
    X_std, _, _ = standardize(_slow_problem(), "binom2")
    op = ft.DenseOperator(X_std, device="cpu")
    n = op.n_samples
    snaps = []

    def capture(panel, values, residuals):
        snaps.append((panel.numpy().copy(), values, residuals))

    cold = eigsh_block(op.gram_permuted, n, 8, maxiter=500, tol=1e-10,
                       dtype=torch.float64, seed=1, checkpoint_every=2,
                       checkpoint_fn=capture)
    assert cold.converged
    assert len(snaps) == (cold.n_restarts - 1) // 2 >= 2
    panel0, values0, resid0 = snaps[0]
    assert panel0.shape[0] == n and 8 <= panel0.shape[1] <= 16
    assert panel0.shape[1] == len(values0) == len(resid0)
    assert np.all(np.diff(values0) <= 1e-9)          # descending
    state = str(tmp_path / "mid.npz")
    tlz.save_state(state, panel0, values0, np.full(len(values0), np.inf),
                   False)
    warm = eigsh_block(op.gram_permuted, n, 8, maxiter=500, tol=1e-10,
                       dtype=torch.float64, seed=1,
                       v0=tlz.load_state(state)["vectors"])
    assert warm.converged and warm.n_restarts < cold.n_restarts
    np.testing.assert_allclose(warm.eigenvalues, cold.eigenvalues,
                               rtol=1e-9)
    # the JAX solver hands out the same number of snapshots
    jop = fj.DenseOperator(X_std, dtype=jnp.float64)
    mv, ops_ = jop.gram_pure()
    jsnaps = []
    jcold = fj.eigsh_block(mv, n, 8, maxiter=500, tol=1e-10,
                           dtype=jnp.float64, seed=1, operands=ops_,
                           checkpoint_every=2,
                           checkpoint_fn=lambda *a: jsnaps.append(a))
    assert jcold.n_restarts == cold.n_restarts
    assert len(jsnaps) == len(snaps)


@pytest.mark.parametrize("mode", ["wide", "tall"])
def test_pca_checkpoint_every_writes_during_solve(tmp_path, monkeypatch,
                                                  mode):
    """Intermediate writes carry converged=False before the final one
    (n sample rows on the wide path, p SNP rows on the tall one)."""
    calls, _ = _spy(monkeypatch, tlz)
    state = str(tmp_path / "during.npz")
    X = _slow_problem()
    if mode == "wide":
        res = ft.pca(X, 8, tol=1e-10, device="cpu", state_out=state,
                     checkpoint_every=3)
        rows = X.shape[0]
    else:
        root = str(tmp_path / "tall")
        from flashpca_tpu.io.plink import write_bed

        write_bed(root, _slow_problem(n=600, p=120))
        res = ft.pca(root, 8, tol=1e-10, device="cpu", state_out=state,
                     checkpoint_every=3, operator_mode="tall")
        rows = 120
    assert res.converged
    assert len(calls) >= 3                     # >= 2 mid-run + 1 final
    assert all(not c for _, c in calls[:-1])
    assert all(shape[0] == rows for shape, _ in calls)
    assert calls[-1] == ((rows, 8), True)
    assert bool(tlz.load_state(state)["converged"])   # final write wins


def test_checkpoint_every_requires_state_out(small_plink):
    root, _ = small_plink
    with pytest.raises(ValueError, match="state_out"):
        ft.pca(root, 2, checkpoint_every=1, device="cpu")


def test_negative_checkpoint_every_raises(small_plink, tmp_path):
    root, _ = small_plink
    with pytest.raises(ValueError, match="positive") as e:
        ft.pca(root, 2, checkpoint_every=-5, device="cpu",
               state_out=str(tmp_path / "s.npz"))
    with pytest.raises(ValueError) as ej:
        fj.pca(root, 2, checkpoint_every=-5,
               state_out=str(tmp_path / "s.npz"))
    assert str(e.value) == str(ej.value)


def test_scalar_fallback_warns_checkpoints_off():
    rng = np.random.default_rng(0)
    n = 12
    A = torch.as_tensor(rng.normal(size=(n, n)))
    A = A @ A.T
    with pytest.warns(RuntimeWarning, match="checkpoint"):
        res = eigsh_block(lambda Q: A @ Q, n, 2, block=8, tol=1e-8,
                          dtype=torch.float64, device="cpu",
                          checkpoint_every=1, checkpoint_fn=lambda *a: None)
    assert res.converged


def test_streamed_checkpoint_resumes_resident(small_plink, tmp_path):
    """An interrupted streamed run (checkpoints on) persists its Ritz
    panel; a resident resume converges to the resident answer."""
    root, _ = small_plink
    state = str(tmp_path / "stream.npz")
    with pytest.raises(RuntimeError, match="not successful"):
        ft.pca(root, 3, tol=1e-12, maxiter=1, streaming=True, memory_mb=1,
               state_out=state, checkpoint_every=1, device="cpu")
    st = tlz.load_state(state)
    assert not bool(st["converged"]) and st["vectors"].shape[1] == 3
    warm = ft.pca(root, 3, tol=1e-9, state_in=state, device="cpu")
    ref = ft.pca(root, 3, tol=1e-9, device="cpu")
    np.testing.assert_allclose(warm.values, ref.values, rtol=1e-7)
    cos = np.abs(np.sum(warm.vectors * ref.vectors, axis=0))
    assert np.all(cos > 1 - 1e-7)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mid_run_checkpoint_resumes_in_the_other_package(tmp_path,
                                                         monkeypatch,
                                                         writer):
    """A mid-run checkpoint (the first, converged=False) written by one
    package warm-starts the other's pca() to the cold run's pairs."""
    X = _slow_problem()
    state = str(tmp_path / "run.npz")
    mod, run = (tlz, lambda: ft.pca(X, 8, tol=1e-10, device="cpu",
                                    state_out=state, checkpoint_every=2)) \
        if writer == "port" else (
        jlz, lambda: fj.pca(X, 8, tol=1e-10, dtype=jnp.float64,
                            state_out=state, checkpoint_every=2))
    _, first = _spy(monkeypatch, mod)
    cold = run()
    monkeypatch.undo()
    mid = str(tmp_path / "mid.npz")
    tlz.save_state(mid, first["vectors"], first["values"],
                   first["residuals"], False)
    assert not bool(jlz.load_state(mid)["converged"])
    warm = (fj.pca(X, 8, tol=1e-10, dtype=jnp.float64, state_in=mid)
            if writer == "port" else
            ft.pca(X, 8, tol=1e-10, device="cpu", state_in=mid))
    assert warm.n_restarts < cold.n_restarts
    np.testing.assert_allclose(warm.values, cold.values, rtol=1e-8)
    cos = np.abs(np.sum(np.asarray(warm.vectors) * cold.vectors, axis=0))
    assert np.all(cos > 1 - 1e-7)


def _cli_in(main, args, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    return main(args)


@pytest.mark.parametrize("extra", [
    ["--checkpoint-every", "-2", "--outstate", "s.npz"],
    ["--checkpoint-every", "2"],
    ["--checkpoint-every", "2", "--outstate", "s.npz", "--ucca",
     "--pheno", "pheno.txt"],
    ["--checkpoint-every", "2", "--outstate", "s.npz", "--check"],
], ids=["negative", "no-outstate", "ucca", "check"])
def test_cli_checkpoint_every_guards_match_jax(small_plink, tmp_path,
                                               monkeypatch, capsys, extra):
    root, geno = small_plink
    np.savetxt(tmp_path / "pheno.txt", np.column_stack([
        np.arange(geno.shape[0]) + 1, np.arange(geno.shape[0]) + 1,
        np.random.default_rng(0).normal(size=(geno.shape[0], 2))]),
        fmt="%s")
    args = ["--bfile", root, "--ndim", "2", "--notime"] + extra
    rj = _cli_in(jmain, args, tmp_path, monkeypatch)
    jerr = capsys.readouterr().err
    rt = _cli_in(tmain, args + ["--device", "cpu"], tmp_path, monkeypatch)
    terr = capsys.readouterr().err
    assert rj == rt == 1
    assert "checkpoint-every" in jerr and "checkpoint-every" in terr
    assert not (tmp_path / "s.npz").exists()


def test_cli_checkpoint_every_writes_and_resumes(small_plink, tmp_path,
                                                 monkeypatch):
    """--checkpoint-every with --outstate in the port's CLI, resumed by
    both CLIs with --instate to the same eigenvalues."""
    root, _ = small_plink
    state = str(tmp_path / "cli.npz")
    base = ["--bfile", root, "--ndim", "3", "--tol", "1e-9", "--notime",
            "--shards", "1"]
    assert _cli_in(tmain, base + ["--outstate", state, "--checkpoint-every",
                                  "1", "--device", "cpu"], tmp_path,
                   monkeypatch) == 0
    assert bool(tlz.load_state(state)["converged"])
    vals = np.loadtxt(tmp_path / "eigenvalues.txt")
    for main, dev in ((tmain, ["--device", "cpu"]), (jmain, [])):
        assert _cli_in(main, base + ["--instate", state] + dev, tmp_path,
                       monkeypatch) == 0
        np.testing.assert_allclose(np.loadtxt(tmp_path / "eigenvalues.txt"),
                                   vals, rtol=1e-7)
