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


def _run_in(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


def _cli(args, cwd):
    return _run_in(tmain, args, cwd)


@pytest.mark.parametrize("extra", [
    [],
    # the JAX CLI's options at the values the port runs as before
    ["--debug", "--shards", "1", "--stream", "off"],
], ids=["plain", "debug-shards1-streamoff"])
def test_cli_pca_reproduces_golden(small_plink, tmp_path, extra):
    root, _ = small_plink
    rc = _cli(["--bfile", root, "--ndim", "3", "--tol", "1e-9",
               "--outload", "loadings.txt", "--outmeansd", "meansd.txt",
               "--verbose", "--device", "cpu"] + extra, tmp_path)
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


def test_cli_checkpoints_resume_across_packages(fileset, tmp_path):
    """--outstate written by either CLI resumes in the other package."""
    from flashpca_tpu.cli import main as jmain

    root = fileset[0]
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert _cli(["--bfile", root, "--ndim", str(K), "--device", "cpu",
                 "--outstate", port_ck, "--notime"], tmp_path) == 0
    port_vals = np.loadtxt(tmp_path / "eigenvalues.txt")
    rj = fj.pca(root, K, state_in=port_ck)
    np.testing.assert_allclose(rj.values, port_vals, rtol=1e-6)

    jdir = tmp_path / "jax"
    jdir.mkdir()
    old = os.getcwd()
    os.chdir(jdir)
    try:
        assert jmain(["--bfile", root, "--ndim", str(K), "--shards", "1",
                      "--outstate", jax_ck, "--notime"]) == 0
    finally:
        os.chdir(old)
    jax_vals = np.loadtxt(jdir / "eigenvalues.txt")
    assert _cli(["--bfile", root, "--ndim", str(K), "--device", "cpu",
                 "--instate", jax_ck, "--notime"], tmp_path) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "eigenvalues.txt"),
                               jax_vals, rtol=1e-6)
    assert jload_state(jax_ck)["vectors"].shape == (fileset[1], K)


@pytest.mark.parametrize("flags, item", [
    (["--shards", "2"], "A18"),
    (["--profile", "trace"], "A10"),
], ids=["shards2", "profile"])
def test_cli_unported_options_name_their_item(fileset, tmp_path, capsys,
                                              flags, item):
    """The JAX CLI's two options that once named their ROADMAP item (A18,
    A10) now run: ``--shards 2 --device cpu`` writes ``--shards 1``'s
    files (float64, two SNP shards: equal to 1e-12), ``--profile DIR``
    writes a Chrome trace of the run into DIR; the CLI's stderr names no
    ROADMAP item."""
    args = ["--bfile", fileset[0], "--device", "cpu", "--ndim", str(K),
            "--outload", "loadings.txt", "--notime"]
    one = tmp_path / "one"
    one.mkdir()
    assert _cli(args, one) == 0
    assert _cli(args + flags, tmp_path) == 0
    assert "ROADMAP" not in capsys.readouterr().err
    for name in ("eigenvalues.txt", "eigenvectors.txt", "pcs.txt",
                 "pve.txt", "loadings.txt"):
        skip = 0 if name in ("eigenvalues.txt", "pve.txt") else 1
        got = np.loadtxt(tmp_path / name, skiprows=skip, usecols=None
                         if skip == 0 else range(2, 2 + K))
        want = np.loadtxt(one / name, skiprows=skip, usecols=None
                          if skip == 0 else range(2, 2 + K))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    if item == "A10":
        traces = list((tmp_path / "trace").glob("*.json"))
        assert len(traces) == 1
        import json

        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any("aten::" in str(e.get("name", "")) for e in events)


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
    """The options that named A12, A14, A17 and A18 run: ``mesh=`` on a
    CPU mesh gives the unsharded values (and a prebuilt operator on
    another mesh raises, as the JAX package's conflict check does)."""
    from flashpca_tpu_torch.parallel import snp_mesh

    root, n, p = fileset
    mesh = snp_mesh(["cpu"] * 2)
    sharded = ft.pca(root, K, device="cpu", mesh=mesh)
    np.testing.assert_allclose(sharded.values,
                               ft.pca(root, K, device="cpu").values,
                               rtol=1e-10)
    from flashpca_tpu_torch.ops.operator import build_packed_operator

    op = build_packed_operator(ft.PlinkDataset.open(root), sharded.center,
                               sharded.scale, mesh=mesh)
    with pytest.raises(ValueError, match="mesh= conflicts"):
        ft.pca(op, K, mesh=snp_mesh(["cpu"] * 3))
    state = str(tmp_path / "ck.npz")
    ran = ft.pca(root, K, device="cpu", checkpoint_every=2, state_out=state)
    assert ran.converged and jload_state(state)["vectors"].shape == (n, K)
    np.testing.assert_allclose(
        ft.pca(root, K, device="cpu", batch=True).values, ran.values,
        rtol=1e-6)
    # streaming the tall gram is ported: it runs and gives the resident
    # tall path's values
    np.testing.assert_allclose(
        ft.pca(root, K, device="cpu", operator_mode="tall",
               streaming=True).values,
        ft.pca(root, K, device="cpu", operator_mode="tall").values,
        rtol=1e-10)
    X = ft.PlinkDataset.open(root).read_matrix(impute_mean=False)
    dense = ft.pca(X, K, device="cpu")
    np.testing.assert_allclose(dense.values, ran.values, rtol=1e-6)
    assert ft.check(X, dense.vectors, dense.values,
                    device="cpu").mse < 1e-8
    assert _cli(["--bfile", root, "--batch", "--ndim", str(K), "--device",
                 "cpu"], tmp_path) == 0
    assert "ROADMAP" not in capsys.readouterr().err


# the JAX CLI's SCCA flags: each read by --scca, accepted and unused in
# the other modes
SCCA_FLAGS = {"outpcx": ["--outpcx", "px.txt"],
              "outpcy": ["--outpcy", "py.txt"],
              "outvecx": ["--outvecx", "vx.txt"],
              "outvecy": ["--outvecy", "vy.txt"],
              "lambda1": ["--lambda1", "0.25"],
              "lambda2": ["--lambda2", "0.5"],
              "save-vinit": ["--save-vinit"]}


def _both_clis(args, tmp_path):
    """Run ``args`` through the JAX CLI and the port's in two fresh
    directories; return the two exit codes and directories."""
    from flashpca_tpu.cli import main as jmain

    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    return (_run_in(jmain, args, jd),
            _run_in(tmain, args + ["--device", "cpu"], td), jd, td)


@pytest.mark.parametrize("mode", ["pca", "ucca", "scca"])
@pytest.mark.parametrize("flag", sorted(SCCA_FLAGS))
def test_cli_scca_flags_match_jax(small_plink, tmp_path, flag, mode):
    root, geno = small_plink
    args = ["--bfile", root, "--ndim", "3", "--tol", "1e-9", "--notime",
            "--shards", "1"] + SCCA_FLAGS[flag]
    if mode != "pca":
        # scca's ndim 3 needs 3 phenotypes (ndim <= min(p, n, k))
        npheno = 2 if mode == "ucca" else 3
        fam = np.loadtxt(root + ".fam", dtype=str)
        Y = np.random.default_rng(7).standard_normal((geno.shape[0],
                                                       npheno))
        pheno = tmp_path / "pheno.txt"
        pheno.write_text("".join(
            f"{f}\t{i}\t" + "\t".join(f"{v:.10g}" for v in y) + "\n"
            for f, i, y in zip(fam[:, 0], fam[:, 1], Y)))
        args += [f"--{mode}", "--pheno", str(pheno)]
    rj, rt, jd, td = _both_clis(args, tmp_path)
    assert rj == rt == 0
    outs = sorted(os.listdir(jd))
    assert outs and outs == sorted(os.listdir(td))
    for fn in outs:
        assert (td / fn).read_bytes() == (jd / fn).read_bytes(), fn


@pytest.mark.parametrize("flag", ["--lambda1", "--lambda2"])
def test_cli_negative_lambda_exits_1_in_both(small_plink, tmp_path, capsys,
                                             flag):
    root, _ = small_plink
    rj, rt, jd, td = _both_clis(["--bfile", root, "--ndim", "2", flag,
                                 "-0.1", "--notime"], tmp_path)
    assert rj == rt == 1
    err = capsys.readouterr().err
    assert err.count(f"{flag} can't be negative") == 2
    assert not os.listdir(jd) and not os.listdir(td)


def test_tall_fileset_takes_the_tall_path_under_auto(tmp_path):
    # n > 2p: auto takes the tall path (X^T X) in both packages, and
    # operator_mode='wide' still decomposes X X^T to the same values
    rng = np.random.default_rng(1)
    geno = rng.binomial(2, 0.3, size=(90, 40)).astype(np.float64)
    root = str(tmp_path / "tall")
    write_bed(root, geno)
    r = ft.pca(root, 3, device="cpu")
    rj = fj.pca(root, 3)
    assert (r.n_ops, r.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(r.values, rj.values, rtol=1e-6)
    assert _rmse(r.vectors, rj.vectors) < 1e-6
    tall = ft.pca(root, 3, device="cpu", operator_mode="tall")
    assert np.array_equal(r.values, tall.values)
    w = ft.pca(root, 3, device="cpu", operator_mode="wide")
    wj = fj.pca(root, 3, operator_mode="wide")
    np.testing.assert_allclose(w.values, wj.values, rtol=1e-6)
    np.testing.assert_allclose(w.values, r.values, rtol=1e-6)


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
