"""The slice as a whole: the port's ``pca()``, ``check()`` and CLI
against the JAX package's, on one synthetic PLINK fileset.

Fileset: 301 samples (n % 4 == 1) x 400 SNPs from five populations of
unequal size, 2% missing calls and one constant SNP, so ``auto`` takes
the wide path and the spectrum has well separated top eigenvalues.  No
panel deflates on it, so both solvers take the same path (the start
panel is numpy ``default_rng(seed)`` in both) and ``n_ops`` must match.

Tolerances:

* float64: eigenvalues rel 1e-6, sign-invariant vector RMSE < 1e-6 (the
  test_parity bar); check mse equal to 2 significant digits.
* float32 with ``polish="contract"``: the two-float refinement makes the
  Ritz values float64-grade up to the float32 rounding of the vectors
  they come from (~1e-7 relative, a few eps), so eigenvalues agree with
  the JAX package's at rel 2e-6 and vectors at RMSE < 1e-6.  check mse
  sits at the float32 floor of the stored vectors (~1e-13 here): its
  digits are rounding noise, so both runs are held to mse < 1e-10, two
  orders below the contract's 1e-8.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.solvers.lanczos import load_state as jload_state
from flashpca_tpu.solvers.lanczos import save_state as jsave_state
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops.operator import packed_operator_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "pca")
K = 5


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    rng = np.random.default_rng(8)
    n, p, pops = 301, 400, 5
    w = 0.7 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.15, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.02] = np.nan
    geno[:, 3] = 1.0
    root = str(tmp_path_factory.mktemp("pca") / "g")
    write_bed(root, geno)
    return root, n, p


@pytest.fixture(scope="module")
def jax_results(fileset):
    root = fileset[0]
    out = {}
    for dt in ("float64", "float32"):
        r = fj.pca(root, K, dtype=getattr(jnp, dt), do_loadings=True)
        c = fj.check(root, r.vectors, r.values, dtype=getattr(jnp, dt))
        out[dt] = (r, c)
    return out


def _rmse(U, V):
    n = U.shape[0]
    return max(min(np.linalg.norm(U[:, j] - V[:, j]),
                   np.linalg.norm(U[:, j] + V[:, j]))
               for j in range(U.shape[1])) / np.sqrt(n)


def test_pca_float64_matches_jax(fileset, jax_results):
    root, n, p = fileset
    rj, cj = jax_results["float64"]
    rt = ft.pca(root, K, device="cpu", do_loadings=True)
    assert rt.vectors.shape == (n, K) and rt.loadings.shape == (p, K)
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert _rmse(rt.projection, rj.projection) < 1e-6
    assert _rmse(rt.loadings, rj.loadings) < 1e-6
    np.testing.assert_allclose(rt.pve, rj.pve, rtol=1e-6)
    np.testing.assert_allclose(rt.trace, rj.trace, rtol=1e-12)
    assert np.array_equal(rt.center, rj.center)
    assert np.array_equal(rt.scale, rj.scale)
    ct = ft.check(root, rt.vectors, rt.values, device="cpu")
    assert abs(ct.mse - cj.mse) <= 5e-3 * cj.mse
    # per component too, where a pair's error is above float64 rounding
    np.testing.assert_allclose(ct.err, cj.err, rtol=5e-3,
                               atol=1e-9 * cj.err.sum())
    # the float32 two-float residual of check() on the same pairs
    c32 = ft.check(root, rt.vectors, rt.values, device="cpu",
                   dtype=torch.float32)
    assert c32.mse < 1e-10


def test_pca_float32_contract_matches_jax(fileset, jax_results):
    root, n, _ = fileset
    rj, cj = jax_results["float32"]
    rt = ft.pca(root, K, device="cpu", dtype=torch.float32,
                polish="contract")
    assert rt.n_ops == rj.n_ops
    np.testing.assert_allclose(rt.values, rj.values, rtol=2e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert rt.gate_mse is not None and rt.gate_mse < 7e-9
    ct = ft.check(root, rt.vectors, rt.values, device="cpu",
                  dtype=torch.float32)
    assert ct.mse < 1e-10 and cj.mse < 1e-10
    assert rt.converged


def test_pca_through_kernel_wrappers(fileset, jax_results):
    """The CUDA path's product code (kernels/packed_matvec.py) with the
    kernels' plain versions, on a prebuilt operator."""
    root, n, _ = fileset
    rj, _ = jax_results["float32"]
    ds = ft.PlinkDataset.open(root)
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    op = packed_operator_from_numpy(ds.read_packed(), mean, sd, n,
                                    snp_sumsq=sumsq, device="cpu",
                                    dtype=torch.float32, use_kernels=True)
    tpk.reset_launch_counts()
    rt = ft.pca(op, K)
    assert rt.n_ops == rj.n_ops
    np.testing.assert_allclose(rt.values, rj.values, rtol=2e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert ft.check(op, rt.vectors, rt.values).mse < 1e-10
    # tensors on the CPU take the plain versions: no kernel launched
    assert set(tpk.launch_counts.values()) == {0}
    assert op.nops > rt.n_ops


def test_pca_fast_polish_and_device_results(fileset, jax_results):
    root, n, _ = fileset
    rj, _ = jax_results["float32"]
    rt = ft.pca(root, K, device="cpu", dtype=torch.float32, polish="fast",
                device_results=True, do_loadings=True)
    assert isinstance(rt.vectors, torch.Tensor)
    assert isinstance(rt.loadings, torch.Tensor)
    assert rt.gate_mse is None
    # the plain float32 polish floors at the float32 product noise
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-4)


def _cli(args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return tmain(args)
    finally:
        os.chdir(old)


def test_cli_pca_reproduces_golden(small_plink, tmp_path):
    root, _ = small_plink
    rc = _cli(["--bfile", root, "--ndim", "3", "--tol", "1e-9",
               "--outload", "loadings.txt", "--outmeansd", "meansd.txt",
               "--verbose", "--device", "cpu"], tmp_path)
    assert rc == 0
    for fn in ("eigenvalues.txt", "eigenvectors.txt", "pcs.txt", "pve.txt",
               "loadings.txt", "meansd.txt"):
        got = (tmp_path / fn).read_bytes()
        with open(os.path.join(GOLDEN, fn), "rb") as fh:
            assert got == fh.read(), fn


def test_cli_check_matches_jax(fileset, tmp_path, capsys):
    root = fileset[0]
    assert _cli(["--bfile", root, "--ndim", "4", "--device", "cpu"],
                tmp_path) == 0
    capsys.readouterr()
    assert _cli(["--bfile", root, "--ndim", "4", "--check", "--device",
                 "cpu", "--notime"], tmp_path) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "Mean squared error" in ln][0]
    mse = float(line.split("Mean squared error: ")[1].split(",")[0])
    from flashpca_tpu.io.text import read_text

    ev = read_text(str(tmp_path / "eigenvalues.txt"), firstcol=1, skip=0)
    U = read_text(str(tmp_path / "eigenvectors.txt"), firstcol=3, skip=1)
    want = fj.check(root, U, ev[:, 0]).mse
    assert abs(mse - want) <= 5e-3 * want


def test_state_in_from_jax_checkpoint(fileset, tmp_path):
    root, n, _ = fileset
    ck = str(tmp_path / "jax_state.npz")
    rj = fj.pca(root, K, state_out=ck)
    rt = ft.pca(root, K, device="cpu", state_in=ck,
                state_out=str(tmp_path / "port_state.npz"))
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    back = jload_state(str(tmp_path / "port_state.npz"))
    assert back["vectors"].shape == (n, K) and bool(back["converged"])
    # a checkpoint whose rows do not match N is refused
    jsave_state(str(tmp_path / "bad.npz"), np.zeros((n + 1, 2)),
                np.ones(2), np.zeros(2), True)
    with pytest.raises(ValueError):
        ft.pca(root, K, device="cpu", state_in=str(tmp_path / "bad.npz"))


def test_entry_points_raise_without_gpu(fileset, tmp_path, monkeypatch):
    root, n, _ = fileset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.pca(root, K)
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.PackedOperator(ds.read_packed(), mean, sd, n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.check(root, np.zeros((n, 2)), np.ones(2))
    assert _cli(["--bfile", root, "--ndim", "2"], tmp_path) == 1
    # asking for the CPU works
    op = ft.PackedOperator(ds.read_packed(), mean, sd, n, device="cpu")
    assert op.device.type == "cpu" and op.dtype == torch.float64


def test_unported_options_raise(fileset, tmp_path, capsys):
    root, n, p = fileset
    cases = [
        (dict(checkpoint_every=2), "A17"),
        (dict(batch=True), "A12"),
        (dict(mesh=object()), "A18"),
        (dict(operator_mode="tall"), "A16"),
        (dict(streaming=True), "A15"),
    ]
    for kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            ft.pca(root, K, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A12"):
        ft.pca(np.zeros((20, 30)), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        ft.check(np.zeros((20, 30)), np.zeros((20, 2)), np.ones(2),
                 device="cpu")
    for flag, item in (("--scca", "A14"), ("--ucca", "A13"),
                       ("--project", "A11"), ("--batch", "A12")):
        assert _cli(["--bfile", root, flag, "--device", "cpu"],
                    tmp_path) == 1
        assert item in capsys.readouterr().err


def test_tall_fileset_is_refused_by_auto(tmp_path):
    # n > 2p: the JAX package's auto mode takes the tall path, which the
    # port does not have yet; operator_mode='wide' still runs
    rng = np.random.default_rng(1)
    geno = rng.binomial(2, 0.3, size=(90, 40)).astype(np.float64)
    root = str(tmp_path / "tall")
    write_bed(root, geno)
    with pytest.raises(NotImplementedError, match="A16"):
        ft.pca(root, 3, device="cpu")
    r = ft.pca(root, 3, device="cpu", operator_mode="wide")
    rj = fj.pca(root, 3, operator_mode="wide")
    np.testing.assert_allclose(r.values, rj.values, rtol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flashpca_tpu'] = None\n"
        "import flashpca_tpu_torch as ft\n"
        "for m in pkgutil.walk_packages(ft.__path__, 'flashpca_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flashpca_tpu' or m.startswith('flashpca_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
