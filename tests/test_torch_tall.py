"""The tall path (the p x p gram X^T X) of the port against the JAX
package's: the B5 plain version and the tall two-float gram against the
Pallas kernels in interpret mode, ``TallPackedOperator`` against the JAX
operator and the float64 dense oracle, ``pca()`` on the tall path, its
dispatch, checkpoints and the CLI's ``--opmode``.

Fixtures:

* the tall fileset of tests/test_tall.py: n = 403 (n % 4 == 3, so the
  last byte of every SNP carries a garbage sample position that the
  tall gram must mask between its stages), p = 23, 3% missing calls,
  plus one constant SNP.  The JAX Pallas kernels pad p to 512 and the
  bytes to 128; the port pads nothing, so their outputs are compared on
  the true rows and samples.  At p = 23 the block solver cannot run
  (ncv + 2 panels > p), so both packages take the scalar Lanczos
  fallback there.
* a second, structured fileset shaped like tests/test_compensated.py's
  packed problem: n = 1203, p = 517 (tall, n > 2p), four populations
  of unequal size, 3% missing calls and an all-missing SNP -- wide
  enough for the block solver and the two-float polish to run as they
  do at scale.

Tolerances, with their reasons:

* float32 plain vs plain (hi halves): rtol 2e-5, atol 2e-4 -- the
  Pallas tests' bar, two float32 accumulation orders.
* two-float pairs (hi + lo in float64) against a float64 product: 5e-6
  relative in norm (tests/test_compensated.py's bar).
* float64 operators: rtol 1e-12 (the same math in another order).
* float32 operator products through the kernel wrappers against the
  interpreted Pallas operator: rtol 1e-4, atol 1e-3
  (tests/test_tall.py's bar).
* float64 ``pca``: equal ``n_ops`` and ``n_restarts``, eigenvalues rtol
  1e-6, sign-invariant vector RMSE < 1e-6 (the test_parity bar).
* float32 ``polish="contract"``: eigenvalues rtol 2e-6 and vector RMSE
  < 1e-6 against the JAX package's (the Ritz values carry ~1e-7 of
  ||A|| from float32 products in both), and check mse < 1e-10 at this
  size, two orders below the contract's 1e-8.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.cli import main as jmain
from flashpca_tpu.io.plink import pack_codes, snp_stats_from_codes, write_bed
from flashpca_tpu.io.text import read_text
from flashpca_tpu.kernels import packed_matvec as jpk
from flashpca_tpu.ops import dense_standardized_np
from flashpca_tpu.ops.compensated import code_value_luts
from flashpca_tpu.ops.operator import TallPackedOperator as JTall
from flashpca_tpu.ops.standardize import lookup_tables
from flashpca_tpu.solvers.lanczos import load_state as jload_state
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops.genotypes import valid_mask_permuted
from flashpca_tpu_torch.ops.operator import (packed_operator_from_numpy,
                                             tall_operator_from_numpy)

torch.set_num_threads(2)

K = 4


@pytest.fixture(scope="module")
def tall(tmp_path_factory):
    rng = np.random.default_rng(5)
    n, p = 403, 23
    geno = rng.binomial(
        2, rng.uniform(0.1, 0.5, p)[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.03] = np.nan
    geno[:, 4] = 1.0                                   # a constant SNP
    root = str(tmp_path_factory.mktemp("tall") / "tall")
    write_bed(root, geno)
    ds = fj.PlinkDataset.open(root)
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    codes = ds.read_codes()
    X = dense_standardized_np(codes, mean, sd).T       # (n, p) float64
    return dict(root=root, n=n, p=p, packed=ds.read_packed(), mean=mean,
                sd=sd, sumsq=sumsq, X=X)


@pytest.fixture(scope="module")
def structured():
    rng = np.random.default_rng(31)
    n, p, pops = 1203, 517, 4
    w = 0.7 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.15, (p, pops)), 0.02, 0.98)
    dosage = rng.binomial(2, freq[:, pop])                       # (p, n)
    codes = np.choose(dosage, [3, 2, 0]).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.03] = 1
    codes[7, :] = 1                                 # an all-missing SNP
    mean, sd = snp_stats_from_codes(codes, "binom2")
    return dict(n=n, p=p, packed=pack_codes(codes, n), mean=mean, sd=sd,
                X=dense_standardized_np(codes, mean, sd).T)


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _rmse(U, V):
    U, V = np.asarray(U), np.asarray(V)
    return max(min(np.linalg.norm(U[:, j] - V[:, j]),
                   np.linalg.norm(U[:, j] + V[:, j]))
               for j in range(U.shape[1])) / np.sqrt(U.shape[0])


def _pallas_operands(tall):
    """The JAX kernels' padded operands: bytes to (512, 128), the exact
    tables and float32 decode rows to 512 rows (zero rows decode to 0)."""
    packed, p = tall["packed"], tall["p"]
    nb = packed.shape[1]
    p_pad, nbp = 512, 128
    pk = np.zeros((p_pad, nbp), dtype=np.uint8)
    pk[:p, :nb] = packed
    lh, ll = code_value_luts(tall["mean"], tall["sd"], p_pad)
    m32, i32 = lookup_tables(tall["mean"], tall["sd"], dtype=np.float32)
    mean = np.zeros(p_pad, np.float32)
    invsd = np.zeros(p_pad, np.float32)
    mean[:p], invsd[:p] = m32, i32
    sample = 4 * np.arange(nbp)[None, :] + np.arange(4)[:, None]
    valid2d = (sample < tall["n"]).astype(np.float32)
    return pk, lh, ll, mean, invsd, valid2d


def _port_luts(tall):
    lh, ll = code_value_luts(tall["mean"], tall["sd"])
    return _t(lh), _t(ll)


def _f64_pair(pair):
    return pair[0].double().numpy() + pair[1].double().numpy()


@pytest.mark.parametrize("k", [1, 8, 28])
def test_matvec_ff_novl_plain_matches_pallas(tall, k):
    """B5's plain version against ``matvec_ff_planes(vh, None)``."""
    p, nb = tall["packed"].shape
    pk, lh, ll, _, _, _ = _pallas_operands(tall)
    v = np.random.default_rng(k).standard_normal((p, k)).astype(np.float32)
    k8 = max(8, -(-k // 8) * 8)
    vh = np.zeros((k8, pk.shape[0]), np.float32)
    vh[:k, :p] = v.T
    jh, jl = jpk.matvec_ff_planes(jnp.asarray(pk),
                                  jpk._lut_rows(jnp.asarray(lh),
                                                jnp.asarray(ll)),
                                  jnp.asarray(vh), None, interpret=True)
    # (4, k8, 128) planes -> the port's (4 * nb, k) permuted layout
    jh, jl = (np.asarray(a)[:, :k, :nb].transpose(0, 2, 1).reshape(4 * nb, k)
              for a in (jh, jl))
    lut6 = tpk.lut_rows(*_port_luts(tall))
    th, tl = tpk.matvec_ff_novl_p(_t(tall["packed"]), lut6, _t(v))
    np.testing.assert_allclose(th.numpy(), jh, rtol=2e-5, atol=2e-4)
    # the pair against W^T v in float64, on the real sample positions
    valid = valid_mask_permuted(tall["n"], nb, torch.float64).numpy() > 0
    Xp = ft.ops.permute_samples(_t(tall["X"]), nb).numpy()   # (n4, p)
    ref = Xp @ v.astype(np.float64)
    got = _f64_pair((th, tl))
    scale = np.linalg.norm(ref[valid])
    assert np.linalg.norm((got - ref)[valid]) / scale < 5e-6
    assert np.linalg.norm((jh.astype(np.float64) + jl - ref)[valid]) / scale \
        < 5e-6
    # B4's plain version with a zero v_lo computes the same pair
    bh, bl = tpk.matvec_ff_plain(_t(tall["packed"]), lut6, _t(v),
                                 torch.zeros((p, k)))
    assert torch.equal(bh, th) and torch.equal(bl, tl)


@pytest.mark.parametrize("k", [1, 8, 28])
def test_gram_tall_ff_plain_matches_pallas(tall, k):
    """The tall two-float gram (B5, mask, B3, B1 on y_lo) against the
    JAX ``gram_tall_ff_p`` with interpreted kernels, and both against
    X^T (X v) in float64."""
    p = tall["p"]
    pk, lh, ll, mean, invsd, valid2d = _pallas_operands(tall)
    v = np.random.default_rng(10 + k).standard_normal((p, k)).astype(
        np.float32)
    vp = np.zeros((pk.shape[0], k), np.float32)
    vp[:p] = v
    jh, jl = jpk.gram_tall_ff_p(jnp.asarray(pk), jnp.asarray(lh),
                                jnp.asarray(ll), jnp.asarray(mean),
                                jnp.asarray(invsd), jnp.asarray(vp),
                                jnp.asarray(valid2d), interpret=True)
    jh, jl = np.asarray(jh)[:p], np.asarray(jl)[:p]
    nb = tall["packed"].shape[1]
    m32, i32 = lookup_tables(tall["mean"], tall["sd"], dtype=np.float32)
    th, tl = tpk.gram_tall_ff_p(
        _t(tall["packed"]), *_port_luts(tall), _t(m32), _t(i32), _t(v),
        valid_mask_permuted(tall["n"], nb, torch.float32))
    np.testing.assert_allclose(th.numpy(), jh, rtol=2e-5, atol=2e-4)
    X = tall["X"]
    ref = X.T @ (X @ v.astype(np.float64))
    scale = np.linalg.norm(ref)
    assert np.linalg.norm(_f64_pair((th, tl)) - ref) / scale < 5e-6
    assert np.linalg.norm(jh + np.asarray(jl, np.float64) - ref) / scale < 5e-6


def test_tall_operator_float64_matches_jax_and_dense(tall):
    n, p, X = tall["n"], tall["p"], tall["X"]
    jop = JTall(tall["packed"], tall["mean"], tall["sd"], n,
                dtype=jnp.float64, use_pallas=False)
    top = tall_operator_from_numpy(tall["packed"], tall["mean"], tall["sd"],
                                   n, device="cpu")
    assert top.dtype == torch.float64 and top.op_dim == p == jop.op_dim
    assert not top.supports_ff and not top.use_kernels
    v = np.random.default_rng(0).standard_normal((p, 3))
    want = np.asarray(jop.unpermute(jop.gram_permuted(jop.permute(
        jnp.asarray(v)))))
    got = top.unpermute(top.gram_permuted(top.permute(v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, X.T @ (X @ v), rtol=1e-12, atol=1e-9)
    got1 = top.gram_permuted(top.permute(v[:, 0])).numpy()
    np.testing.assert_allclose(got1, got[:, 0], rtol=1e-12, atol=1e-12)
    y = top.prod(v).numpy()
    assert y.shape == (n, 3)
    np.testing.assert_allclose(y, np.asarray(jop.prod(v)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(y, X @ v, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(top.snp_sumsq, jop.snp_sumsq, rtol=1e-12)
    np.testing.assert_allclose(top.snp_sumsq, (X ** 2).sum(0), rtol=1e-12)
    np.testing.assert_allclose(top.trace, jop.trace, rtol=1e-12)
    # a precomputed snp_sumsq makes trace free and gives the same value
    pre = tall_operator_from_numpy(tall["packed"], tall["mean"], tall["sd"],
                                   n, device="cpu", snp_sumsq=tall["sumsq"])
    np.testing.assert_allclose(pre.trace, top.trace, rtol=1e-12)
    st = top.stats()
    assert st["nops"] == top.nops == 3 and st["use_kernels"] is False
    with pytest.raises(NotImplementedError):
        top.gram_ff_permuted(top.permute(v))


def test_tall_operator_float32_kernels_match_pallas(tall):
    n, p, X = tall["n"], tall["p"], tall["X"]
    jop = JTall(tall["packed"], tall["mean"], tall["sd"], n,
                dtype=jnp.float32, use_pallas="interpret")
    top = tall_operator_from_numpy(tall["packed"], tall["mean"], tall["sd"],
                                   n, device="cpu", dtype=torch.float32,
                                   use_kernels=True)
    assert top.supports_ff and jop.supports_ff
    v = np.random.default_rng(7).standard_normal((p, 2))
    tpk.reset_launch_counts()
    want = np.asarray(jop.unpermute(jop.gram_permuted(jop.permute(
        jnp.asarray(v, jnp.float32)))))
    got = top.gram_permuted(top.permute(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, X.T @ (X @ v), rtol=1e-4, atol=1e-3)
    y = top.prod(v).numpy()
    np.testing.assert_allclose(y, np.asarray(jop.prod(v)), rtol=1e-4,
                               atol=1e-3)
    hi, lo = top.gram_ff_permuted(top.permute(v))
    ref = X.T @ (X @ v.astype(np.float32).astype(np.float64))
    rel = np.linalg.norm(_f64_pair((hi, lo)) - ref) / np.linalg.norm(ref)
    assert rel < 5e-6
    assert top.nops == 3
    assert set(tpk.launch_counts.values()) == {0}
    with pytest.raises(ValueError):
        ft.TallPackedOperator(tall["packed"], tall["mean"], tall["sd"], n,
                              device="cpu", use_kernels=True)   # float64


def test_tall_pca_float64_matches_jax(tall):
    root = tall["root"]
    rj = fj.pca(root, K, dtype=jnp.float64, operator_mode="tall",
                do_loadings=True)
    rt = ft.pca(root, K, device="cpu", operator_mode="tall",
                do_loadings=True)
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-6)
    assert rt.vectors.shape == (tall["n"], K)
    assert rt.loadings.shape == (tall["p"], K)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert _rmse(rt.projection, rj.projection) < 1e-6
    assert _rmse(rt.loadings, rj.loadings) < 1e-6
    np.testing.assert_allclose(rt.pve, rj.pve, rtol=1e-6)
    np.testing.assert_allclose(rt.trace, rj.trace, rtol=1e-12)
    assert rt.converged and rt.gate_mse is None
    # the tall and the wide gram share their top spectrum
    rw = ft.pca(root, K, device="cpu", operator_mode="wide", tol=1e-9)
    np.testing.assert_allclose(rt.values, rw.values, rtol=1e-6)
    assert _rmse(rt.vectors, rw.vectors) < 1e-6


def test_tall_pca_float32_contract_matches_jax(structured):
    s = structured
    n, p = s["n"], s["p"]
    jop = JTall(s["packed"], s["mean"], s["sd"], n, dtype=jnp.float32,
                use_pallas="interpret")
    rj = fj.pca(jop, K)
    top = tall_operator_from_numpy(s["packed"], s["mean"], s["sd"], n,
                                   device="cpu", dtype=torch.float32,
                                   use_kernels=True)
    tpk.reset_launch_counts()
    rt = ft.pca(top, K, polish="contract")
    np.testing.assert_allclose(rt.values, rj.values, rtol=2e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert rt.converged
    # tensors on the CPU take the plain versions: no CUDA launch
    assert set(tpk.launch_counts.values()) == {0}
    assert top.nops > rt.n_ops
    # check() of the tall result through a wide operator on the same bytes
    wide = packed_operator_from_numpy(s["packed"], s["mean"], s["sd"], n,
                                      device="cpu", dtype=torch.float32,
                                      use_kernels=True)
    assert ft.check(wide, rt.vectors, rt.values).mse < 1e-10
    X = s["X"]
    lam = np.linalg.eigvalsh(X.T @ X / p)[::-1][:K]
    np.testing.assert_allclose(rt.values, lam, rtol=2e-6)


def test_tall_fast_polish_and_device_results(tall):
    top = tall_operator_from_numpy(tall["packed"], tall["mean"], tall["sd"],
                                   tall["n"], device="cpu",
                                   dtype=torch.float32)
    # without the kernel wrappers there is no two-float gram: the
    # contract polish logs a note and runs the plain float32 polish
    assert not top.supports_ff
    r = ft.pca(top, K, device_results=True, do_loadings=True)
    assert isinstance(r.vectors, torch.Tensor)
    assert isinstance(r.loadings, torch.Tensor)
    rf = ft.pca(tall["root"], K, device="cpu", dtype=torch.float32,
                operator_mode="tall", polish="fast")
    r64 = ft.pca(tall["root"], K, device="cpu", operator_mode="tall")
    np.testing.assert_allclose(r.values, r64.values, rtol=1e-4)
    np.testing.assert_allclose(rf.values, r64.values, rtol=1e-4)
    assert _rmse(r.vectors.numpy(), r64.vectors) < 1e-4


def test_auto_dispatch_and_conflicts(tall, tmp_path):
    root, n = tall["root"], tall["n"]
    # check() verifies the wide decomposition only
    top = tall_operator_from_numpy(tall["packed"], tall["mean"], tall["sd"],
                                   n, device="cpu")
    with pytest.raises(ValueError, match="WIDE decomposition"):
        ft.check(top, np.zeros((n, 2)), np.ones(2))
    # a prebuilt operator fixes the decomposition shape
    with pytest.raises(ValueError, match="conflicts"):
        ft.pca(top, K, operator_mode="wide")
    wide = packed_operator_from_numpy(tall["packed"], tall["mean"],
                                      tall["sd"], n, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        ft.pca(wide, K, operator_mode="tall")
    with pytest.raises(ValueError, match="conflicts"):
        ft.pca(top, K, dtype=torch.float32)
    # the prebuilt tall operator and the fileset give the same result
    a = ft.pca(top, K)
    b = ft.pca(root, K, device="cpu")
    np.testing.assert_allclose(a.values, b.values, rtol=1e-12)
    assert (a.n_ops, a.n_restarts) == (b.n_ops, b.n_restarts)


def test_tall_state_in_from_jax_checkpoint(tall, tmp_path):
    root, n, p = tall["root"], tall["n"], tall["p"]
    ck = str(tmp_path / "jax_tall.npz")
    rj = fj.pca(root, K, dtype=jnp.float64, operator_mode="tall",
                state_out=ck)
    assert jload_state(ck)["vectors"].shape[0] == p
    out = str(tmp_path / "port_tall.npz")
    rt = ft.pca(root, K, device="cpu", state_in=ck, state_out=out)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    back = jload_state(out)
    assert back["vectors"].shape == (p, K) and bool(back["converged"])
    # the port's tall checkpoint resumes in the JAX package
    rj2 = fj.pca(root, K, dtype=jnp.float64, operator_mode="tall",
                 state_in=out)
    np.testing.assert_allclose(rj2.values, rj.values, rtol=1e-6)
    # a sample-space (wide) checkpoint has the wrong row count here
    wide_ck = str(tmp_path / "wide.npz")
    ft.pca(root, K, device="cpu", operator_mode="wide", state_out=wide_ck)
    with pytest.raises(ValueError, match="rows"):
        ft.pca(root, K, device="cpu", state_in=wide_ck)
    assert n != p


def _cli(fn, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return fn(args)
    finally:
        os.chdir(old)


def test_cli_opmode_tall_matches_jax(tall, tmp_path, capsys):
    root = tall["root"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    common = ["--bfile", root, "--ndim", str(K), "--opmode", "tall",
              "--outload", "loadings.txt"]
    assert _cli(jmain, common + ["--dtype", "float64", "--shards", "1"],
                jdir) == 0
    assert _cli(tmain, common + ["--device", "cpu"], tdir) == 0
    vals = [read_text(str(d / "eigenvalues.txt"), firstcol=1, skip=0)[:, 0]
            for d in (jdir, tdir)]
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-6)
    for fn in ("eigenvectors.txt", "pcs.txt", "loadings.txt"):
        a, b = (read_text(str(d / fn), firstcol=3, skip=1)
                for d in (jdir, tdir))
        assert a.shape == b.shape and _rmse(b, a) < 1e-6, fn
    pve = [read_text(str(d / "pve.txt"), firstcol=1, skip=0)[:, 0]
           for d in (jdir, tdir)]
    np.testing.assert_allclose(pve[1], pve[0], rtol=1e-6)
    capsys.readouterr()
    # --opmode is a PCA-mode option
    assert _cli(tmain, ["--bfile", root, "--check", "--opmode", "tall",
                        "--device", "cpu"], tdir) == 1
    assert "--opmode applies to PCA mode only" in capsys.readouterr().err


def _chip_smoke():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_tall_float64_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's float64 tall phase at a tiny size on the CPU: one
    float64 gram pass timed; a budget it misses cuts the SNP depth to
    whole 1,024s (never the samples), a budget it meets keeps all SNPs;
    the float64 pca on that depth holds to the leading block of the
    float64 reference gram within EIG_BAR of the largest, and launches
    no kernel."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    n, p, k = 2003, 2100, 6
    packed, mean, sd, sumsq = cs.card_data(torch.device("cpu"), n, p, 8)
    top = ft.TallPackedOperator(packed, mean, sd, n, device="cpu",
                                dtype=torch.float32, use_kernels=True,
                                snp_sumsq=sumsq)
    depth, pass_s = cs.float64_depth(top, budget_s=1e-9, passes=1)
    assert depth == 1024 and pass_s > 0
    assert cs.float64_depth(top, budget_s=1e9, passes=1)[0] == p
    ref, cut = cs.f64_reference(top, k + 8, depth=depth)
    assert cut.eigenvectors.shape[0] == depth
    out = cs.tall_float64(top, k, depth, cut)
    assert out["depth"] == depth
    assert out["eig_err_of_largest"] <= cs.EIG_BAR


def test_tall_f64_depths_tool_needs_a_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import tall_f64_depths

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tall_f64_depths.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
