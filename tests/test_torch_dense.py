"""Dense and matrix inputs: the port's ``DenseOperator``,
``dense_gram_ff``, ``pca``/``check``/``ucca`` on a numeric matrix,
``batch=True``, ``flashpca()`` and the CLI's ``--batch`` against the JAX
package's.

Matrix: 157 samples x 120 SNPs (seed 21) from four populations of
unequal size, 2% missing calls (NaN, mean-imputed) and one constant
SNP, so the top eigenvalues are well separated and both solvers take
the same path from the same start panel.

Tolerances:

* ``DenseOperator`` at float64: every product, ``trace`` and
  ``snp_sumsq`` at rtol 1e-12 (the same float64 products in another
  summation order; products' near-cancelling entries within 1e-12 of
  the largest);
* ``dense_gram_ff`` at float32: hi + lo within 1e-6 of each column's
  largest |entry| of the JAX pair's hi + lo, and of the float64 product
  of the same float32 X;
* ``pca(X)`` at float64 (tol 1e-10): eigenvalues rtol 1e-10,
  sign-aligned vectors atol 1e-8; at float32 ``polish="contract"``:
  eigenvalues rtol 2e-6 and check mse < 1e-8;
* ``pca(root, batch=True)``: eigenvalues rtol 1e-7 against both
  packages' packed runs (tests/test_pca.py's bar);
* ``check`` err and ``ucca`` R, F and P: rtol 1e-10;
* the CLI's files: byte for byte against the JAX CLI's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.cli import main as jmain
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.models.pca import flashpca as jflashpca
from flashpca_tpu.ops.compensated import dense_gram_ff as jdense_gram_ff
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops import compensated as tcomp
from flashpca_tpu_torch.ops.standardize import standardize

torch.set_num_threads(2)

K = 4
STANDS = ("binom2", "binom", "sd", "center", "none")


def _geno(seed=21, n=157, p=120, pops=4, missing=0.02):
    rng = np.random.default_rng(seed)
    w = 0.6 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.2, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < missing] = np.nan
    geno[:, 9] = 1.0
    return geno


@pytest.fixture(scope="module")
def geno():
    return _geno()


@pytest.fixture(scope="module")
def ops(geno):
    """The same standardized matrix in both packages' DenseOperator."""
    X_std, mean, sd = standardize(geno, "binom2")
    return (ft.DenseOperator(X_std, device="cpu", center=mean, scale=sd),
            fj.DenseOperator(X_std, dtype=jnp.float64, center=mean,
                             scale=sd), X_std)


def _aligned(U, V):
    """U's columns flipped to V's signs."""
    return U * np.sign(np.sum(U * V, axis=0))[None, :]


def test_dense_operator_products_match_jax(ops):
    top, jop, X = ops
    n, p = X.shape
    rng = np.random.default_rng(3)
    x, v = rng.standard_normal((n, 5)), rng.standard_normal((p, 5))
    assert top.dtype == torch.float64 and top.device.type == "cpu"
    assert (top.n_samples, top.n_snps, top.op_dim) == (n, p, n)
    assert top.supports_ff
    for name, arg in (("perform_op", x), ("crossprod", x), ("prod", v),
                      ("perform_op", x[:, 0]), ("prod", v[:, 0])):
        got = getattr(top, name)(arg).numpy()
        want = np.asarray(getattr(jop, name)(arg))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    want = np.asarray(jop.gram_permuted(x))
    np.testing.assert_allclose(top.gram_permuted(top.permute(x)).numpy(),
                               want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(top.trace, jop.trace, rtol=1e-12)
    np.testing.assert_allclose(top.snp_sumsq, jop.snp_sumsq, rtol=1e-12)
    assert np.array_equal(top.permute_np(x), x)
    assert torch.equal(top.unpermute(top.permute(x)), torch.as_tensor(x))
    # the uncounted products SCCA's device engine runs
    nops = top.nops
    np.testing.assert_allclose(top._cross_p(torch.as_tensor(x)).numpy(),
                               X.T @ x, rtol=1e-12)
    np.testing.assert_allclose(top._mv_p(torch.as_tensor(v)).numpy(),
                               X @ v, rtol=1e-12)
    assert top.nops == nops
    assert np.array_equal(top.center, jop.center)
    assert np.array_equal(top.scale, jop.scale)


def test_dense_operator_holds_a_device_tensor_in_place(ops):
    X = torch.as_tensor(ops[2])
    op = ft.DenseOperator(X, device="cpu")
    assert op.X.data_ptr() == X.data_ptr()
    assert np.array_equal(op.center, np.zeros(X.shape[1]))
    assert np.array_equal(op.scale, np.ones(X.shape[1]))
    assert ft.DenseOperator(X, device="cpu",
                            dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="2-D"):
        ft.DenseOperator(X[0], device="cpu")


def test_dense_operator_copies_a_numpy_array(ops):
    """A numpy matrix is copied (as the JAX operator's jnp.asarray
    does): editing the caller's array leaves the operator as it was."""
    X = ops[2].copy()
    op = ft.DenseOperator(X, device="cpu")
    want = op.X.clone()
    X[:] = 0.0
    assert torch.equal(op.X, want)


@pytest.mark.parametrize("entry", ["check", "ucca"])
def test_matrix_entry_points_run_on_the_requested_device(geno, monkeypatch,
                                                         entry):
    """check() and ucca() on a numeric matrix resolve the device first:
    without a GPU the default (cuda) raises before the standardization;
    device='cpu' builds a DenseOperator there, in float64 unless dtype
    says otherwise."""
    import sys

    n = geno.shape[0]
    Y = np.random.default_rng(8).standard_normal((n, 2))
    U, d = np.linalg.qr(np.ones((n, 2)) + np.eye(n, 2))[0], np.ones(2)

    def call(**kw):
        if entry == "check":
            return ft.check(geno, U, d, **kw)
        return ft.ucca(geno, Y, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(device=device)
    built = []
    mod = sys.modules["flashpca_tpu_torch.ops.operator"]

    def spy(*a, **kw):
        op = ft.DenseOperator(*a, **kw)
        built.append(op)
        return op

    monkeypatch.setattr(mod, "DenseOperator", spy)
    want = call(device="cpu")
    low = call(device="cpu", dtype=torch.float32)
    assert [(o.device.type, o.dtype) for o in built] == [
        ("cpu", torch.float64), ("cpu", torch.float32)]
    assert built[0].n_samples == n
    if entry == "check":
        np.testing.assert_allclose(low.err, want.err, rtol=1e-5)
    else:
        np.testing.assert_allclose(low.result[:, :2], want.result[:, :2],
                                   rtol=1e-4)


@pytest.mark.parametrize("n, p, chunk", [
    (2500, 300, None),        # N % 2048 != 0: a short last row chunk
    (301, 150, 64),
    (257, 130, 2048),         # one chunk, shorter than the chunk length
], ids=["ragged-2048", "chunk64", "one-chunk"])
def test_dense_gram_ff_matches_jax(n, p, chunk):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, p)).astype(np.float32)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    hi, lo = tcomp.dense_gram_ff(torch.as_tensor(X), torch.as_tensor(x),
                                 chunk=chunk)
    got = hi.double().numpy() + lo.double().numpy()
    jh, jl = jdense_gram_ff(jnp.asarray(X), jnp.asarray(x))
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    X64 = X.astype(np.float64)
    exact = X64 @ (X64.T @ x.astype(np.float64))
    for ref in (want, exact):
        bar = 1e-6 * np.abs(ref).max(axis=0)
        assert np.all(np.abs(got - ref).max(axis=0) <= bar)


def test_dense_gram_ff_copies_no_part_of_x(monkeypatch):
    """Every product of X in the ragged two-float gram reads a view of
    X's own storage (a padded, permuted or contiguous copy would have
    storage of its own), and nothing concatenates X."""
    n, p, chunk = 2500, 300, 2048
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((n, p)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32))
    base = X.untyped_storage().data_ptr()
    end = base + X.untyped_storage().nbytes()
    seen = {"matmul": 0, "x_views": 0}
    real_matmul, real_cat = torch.matmul, torch.cat

    def on_x(t):
        return (t.untyped_storage().data_ptr() == base
                and base <= t.data_ptr() < end)

    def matmul(a, b, **kw):
        seen["matmul"] += 1
        seen["x_views"] += on_x(a)
        return real_matmul(a, b, **kw)

    def cat(ts, *a, **kw):
        assert not any(on_x(t) for t in ts), "X was concatenated"
        return real_cat(ts, *a, **kw)

    monkeypatch.setattr(torch, "matmul", matmul)
    monkeypatch.setattr(torch, "cat", cat)
    hi, lo = tcomp.dense_gram_ff(X, x, chunk=chunk)
    monkeypatch.undo()
    n_chunks = -(-n // chunk) + -(-p // chunk)
    assert seen == {"matmul": n_chunks, "x_views": n_chunks}
    assert hi.shape == lo.shape == (n, 3)


def test_dense_operator_ff_gram_at_float32(ops):
    top, _, X = ops
    op32 = ft.DenseOperator(X, device="cpu", dtype=torch.float32)
    x = np.random.default_rng(4).standard_normal((X.shape[0], 3))
    hi, lo = op32.perform_op_ff(x)
    got = hi.double().numpy() + lo.double().numpy()
    X32 = X.astype(np.float32).astype(np.float64)
    exact = X32 @ (X32.T @ x.astype(np.float32).astype(np.float64))
    assert np.all(np.abs(got - exact).max(axis=0)
                  <= 1e-6 * np.abs(exact).max(axis=0))
    h1, l1 = op32.perform_op_ff(x[:, 0])
    assert h1.shape == l1.shape == (X.shape[0],)


@pytest.fixture(scope="module")
def jax_matrix_runs(geno):
    return {(stand, div): fj.pca(geno, K, stand=stand, divisor=div,
                                 tol=1e-10, dtype=jnp.float64)
            for stand in STANDS for div in ("p", "n1", "none")}


@pytest.mark.parametrize("div", ["p", "n1", "none"])
@pytest.mark.parametrize("stand", STANDS)
def test_pca_matrix_matches_jax(geno, jax_matrix_runs, stand, div):
    rj = jax_matrix_runs[stand, div]
    rt = ft.pca(geno, K, stand=stand, divisor=div, tol=1e-10, device="cpu")
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-10)
    np.testing.assert_allclose(_aligned(rt.vectors, rj.vectors), rj.vectors,
                               atol=1e-8)
    np.testing.assert_allclose(rt.trace, rj.trace, rtol=1e-12)
    np.testing.assert_allclose(rt.pve, rj.pve, rtol=1e-10)
    assert np.array_equal(rt.center, rj.center)
    assert np.array_equal(rt.scale, rj.scale)


def test_pca_matrix_loadings_and_prebuilt_operator(geno, ops):
    top, jop, _ = ops
    rj = fj.pca(geno, K, tol=1e-10, dtype=jnp.float64, do_loadings=True)
    rt = ft.pca(geno, K, tol=1e-10, device="cpu", do_loadings=True)
    np.testing.assert_allclose(_aligned(rt.loadings, rj.loadings),
                               rj.loadings, atol=1e-8)
    # a prebuilt DenseOperator: the same run, device results on request
    ro = ft.pca(top, K, tol=1e-10, device_results=True, do_loadings=True)
    assert isinstance(ro.vectors, torch.Tensor)
    np.testing.assert_allclose(ro.values, rj.values, rtol=1e-10)
    np.testing.assert_allclose(_aligned(ro.loadings.numpy(), rj.loadings),
                               rj.loadings, atol=1e-8)
    rjo = fj.pca(jop, K, tol=1e-10)
    np.testing.assert_allclose(ro.values, rjo.values, rtol=1e-10)
    for kw, what in ((dict(dtype=torch.float32), "dtype="),
                     (dict(streaming=True), "streaming=True"),
                     (dict(memory_mb=8), "memory_mb="),
                     (dict(block_size=8), "block_size="),
                     (dict(batch=True), "batch=True"),
                     (dict(operator_mode="tall"), "operator_mode")):
        with pytest.raises(ValueError, match=what):
            ft.pca(top, K, **kw)


def test_pca_matrix_float32_contract(geno):
    rj = fj.pca(geno, K, dtype=jnp.float32)
    rt = ft.pca(geno, K, device="cpu", dtype=torch.float32)
    assert rt.n_ops == rj.n_ops
    np.testing.assert_allclose(rt.values, rj.values, rtol=2e-6)
    assert rt.gate_mse is not None and rt.gate_mse < 7e-9
    assert ft.check(geno, rt.vectors, rt.values, device="cpu").mse < 1e-8
    X_std, mean, sd = standardize(geno, "binom2")
    op32 = ft.DenseOperator(X_std, device="cpu", dtype=torch.float32,
                            center=mean, scale=sd)
    c32 = ft.check(op32, rt.vectors, rt.values)
    cj = fj.check(fj.DenseOperator(X_std, dtype=jnp.float32, center=mean,
                                   scale=sd), rt.vectors, rt.values)
    assert c32.mse < 1e-8 and cj.mse < 1e-8
    # the dense operator runs no kernel wrapper
    tpk.reset_launch_counts()
    ft.pca(op32, K)
    assert set(tpk.launch_counts.values()) == {0}


def test_pca_batch_matches_packed_runs(small_plink):
    root, _ = small_plink
    rb = ft.pca(root, 3, tol=1e-10, batch=True, device="cpu")
    for ref in (ft.pca(root, 3, tol=1e-10, device="cpu"),
                fj.pca(root, 3, tol=1e-10),
                fj.pca(root, 3, tol=1e-10, batch=True)):
        np.testing.assert_allclose(rb.values, ref.values, rtol=1e-7)
    rj = fj.pca(root, 3, tol=1e-10, batch=True)
    assert np.array_equal(rb.center, rj.center)
    assert np.array_equal(rb.scale, rj.scale)
    # streaming / memory_mb under batch are logged and ignored
    rs = ft.pca(root, 3, tol=1e-10, batch=True, device="cpu",
                streaming=True, memory_mb=1)
    assert np.array_equal(rs.values, rb.values)


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(streaming=True), dict(memory_mb=64), dict(operator_mode="tall"),
    dict(device_results=True)],
    ids=["streaming", "memory_mb", "tall", "device_results"])
def test_matrix_refusals_match_jax(geno, kw):
    assert (_raised(lambda: ft.pca(geno, 2, device="cpu", **kw))
            == _raised(lambda: fj.pca(geno, 2, **kw)))


@pytest.mark.parametrize("kw", [dict(operator_mode="tall"),
                                dict(device_results=True)],
                         ids=["tall", "device_results"])
def test_batch_refusals_match_jax(small_plink, kw):
    root, _ = small_plink
    assert (_raised(lambda: ft.pca(root, 2, batch=True, device="cpu", **kw))
            == _raised(lambda: fj.pca(root, 2, batch=True, **kw)))


def test_check_geno(geno):
    X = np.arange(100, dtype=np.float64).reshape(10, 10)
    msg = _raised(lambda: ft.pca(X, 2, device="cpu"))
    assert "values other than {0, 1, 2}" in msg
    assert msg == _raised(lambda: fj.pca(X, 2))
    Xn = X + np.random.default_rng(1).normal(size=(10, 10))
    np.testing.assert_allclose(
        ft.pca(Xn, 2, stand="sd", device="cpu").values,
        fj.pca(Xn, 2, stand="sd").values, rtol=1e-8)
    # check_geno=False lets binom2 run on other values, as in JAX
    Xg = np.where(geno == 2, 3.0, geno)
    np.testing.assert_allclose(
        ft.pca(Xg, K, check_geno=False, tol=1e-10, device="cpu").values,
        fj.pca(Xg, K, check_geno=False, tol=1e-10).values, rtol=1e-10)
    for bad in (np.zeros(10), np.zeros((1, 5))):
        assert (_raised(lambda: ft.pca(bad, 1, device="cpu"))
                == _raised(lambda: fj.pca(bad, 1)))


@pytest.mark.parametrize("stand", ["binom2", "sd"])
def test_check_matrix_and_dense_operator_match_jax(geno, ops, stand):
    top, jop, _ = ops
    r = ft.pca(geno, K, stand=stand, device="cpu")
    noisy = r.vectors + 1e-4 * np.random.default_rng(2).standard_normal(
        r.vectors.shape)
    ct = ft.check(geno, noisy, r.values, stand=stand, device="cpu")
    cj = fj.check(geno, noisy, r.values, stand=stand)
    np.testing.assert_allclose(ct.err, cj.err, rtol=1e-10)
    np.testing.assert_allclose(ct.mse, cj.mse, rtol=1e-10)
    if stand == "binom2":
        co = ft.check(top, noisy, r.values)
        cjo = fj.check(jop, noisy, r.values)
        np.testing.assert_allclose(co.err, cjo.err, rtol=1e-10)
        np.testing.assert_allclose(co.err, ct.err, rtol=1e-10)
        with pytest.raises(ValueError, match="stand="):
            ft.check(top, noisy, r.values, stand="binom")


def test_ucca_dense_operator_matches_jax(geno, ops):
    top, jop, _ = ops
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((geno.shape[0], 3))
    Y[:, 0] += 0.7 * np.nan_to_num(geno[:, 30] - np.nanmean(geno[:, 30]))
    got = ft.ucca(top, Y).result
    want = fj.ucca(jop, Y).result
    flat = np.isnan(want[:, 0])
    assert np.array_equal(np.isnan(got[:, 0]), flat) and flat[9]
    np.testing.assert_allclose(got[~flat], want[~flat], rtol=1e-10)
    np.testing.assert_allclose(
        got[~flat], ft.ucca(geno, Y, device="cpu").result[~flat],
        rtol=1e-10)
    with pytest.raises(ValueError, match="stand_x="):
        ft.ucca(top, Y, stand_x="binom")


def test_flashpca_alias_and_scale2(geno, ops, small_plink):
    rt = ft.flashpca(geno, 3, device="cpu")
    rj = jflashpca(geno, 3)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-8)
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    # a prebuilt operator does not receive the R default block_size=1000
    np.testing.assert_allclose(ft.flashpca(ops[0], 3).values,
                               jflashpca(ops[1], 3).values, rtol=1e-8)
    root, _ = small_plink
    np.testing.assert_allclose(ft.flashpca(root, 3, device="cpu").values,
                               jflashpca(root, 3).values, rtol=1e-8)
    for typ in ("1", "2"):
        got = ft.scale2(np.nan_to_num(geno), type=typ)
        want = fj.scale2(np.nan_to_num(geno), type=typ)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert ft.DenseOperator is ft.ops.operator.DenseOperator


def _run(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


def _same_files(a, b):
    outs = sorted(f for f in os.listdir(a) if not f.endswith(".npz"))
    assert outs and outs == sorted(f for f in os.listdir(b)
                                   if not f.endswith(".npz"))
    for fn in outs:
        assert (a / fn).read_bytes() == (b / fn).read_bytes(), fn


def test_cli_batch_pca_matches_jax(small_plink, tmp_path):
    """--batch with --outstate: every text file byte for byte as the
    JAX CLI's.  Then --instate from one checkpoint: the same eigenvalues
    (rtol 1e-7) and, up to their signs, vectors (atol 1e-6, the files'
    7 digits) -- a warm start from converged vectors breaks down at
    once, and each package splices in directions from its own random
    generator; the port's checkpoint resumes in the JAX CLI too."""
    root, _ = small_plink
    base = ["--bfile", root, "--ndim", "3", "--tol", "1e-9", "--batch",
            "--notime", "--shards", "1", "--outload", "load.txt",
            "--outmeansd", "meansd.txt"]
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    assert _run(jmain, base + ["--outstate", "ck.npz"], jd) == 0
    assert _run(tmain, base + ["--outstate", "ck.npz", "--device", "cpu"],
                td) == 0
    _same_files(jd, td)
    assert (td / "ck.npz").exists()
    # both resume from the JAX CLI's checkpoint, the JAX CLI also from
    # the port's
    assert _run(jmain, base + ["--instate", str(jd / "ck.npz")], jd) == 0
    jd2 = tmp_path / "jax2"
    jd2.mkdir()
    for main, d, ck in ((tmain, td, jd), (jmain, jd2, td)):
        dev = ["--device", "cpu"] if main is tmain else []
        assert _run(main, base + ["--instate", str(ck / "ck.npz")] + dev,
                    d) == 0
        np.testing.assert_allclose(np.loadtxt(d / "eigenvalues.txt"),
                                   np.loadtxt(jd / "eigenvalues.txt"),
                                   rtol=1e-7)
        for fn in ("eigenvectors.txt", "pcs.txt"):
            got = np.loadtxt(d / fn, skiprows=1, usecols=(2, 3, 4))
            want = np.loadtxt(jd / fn, skiprows=1, usecols=(2, 3, 4))
            np.testing.assert_allclose(_aligned(got, want), want,
                                       atol=1e-6)


def test_cli_batch_check_after_batch_pca(small_plink, tmp_path, capsys):
    root, _ = small_plink
    args = ["--bfile", root, "--ndim", "3", "--device", "cpu", "--notime"]
    assert _run(tmain, args + ["--batch"], tmp_path) == 0
    capsys.readouterr()
    assert _run(tmain, args + ["--check"], tmp_path) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "Mean squared error" in ln][0]
    assert float(line.split("Mean squared error: ")[1].split(",")[0]) < 1e-8


def _write_pheno(path, fam_root, Y):
    fam = np.loadtxt(fam_root + ".fam", dtype=str)
    with open(path, "w") as fh:
        for i in range(Y.shape[0]):
            fh.write(f"{fam[i, 0]}\t{fam[i, 1]}\t"
                     + "\t".join(f"{v:.10g}" for v in Y[i]) + "\n")


@pytest.mark.parametrize("flags", [[], ["--standy", "center",
                                        "--outmeansd", "ms.txt"]],
                         ids=["plain", "center-outmeansd"])
def test_cli_ucca_batch_matches_jax(tmp_path, flags):
    geno = _geno(seed=23, n=97, p=60)
    root = str(tmp_path / "u")
    write_bed(root, geno)
    Y = np.random.default_rng(6).standard_normal((97, 2))
    pheno = str(tmp_path / "pheno.txt")
    _write_pheno(pheno, root, Y)
    args = ["--bfile", root, "--ucca", "--batch", "--pheno", pheno,
            "--notime"] + flags
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    assert _run(jmain, args, jd) == 0
    assert _run(tmain, args + ["--device", "cpu"], td) == 0
    _same_files(jd, td)
    if not torch.cuda.is_available():
        # the CLI's default device is cuda: without a GPU it exits 1
        assert _run(tmain, args, td) == 1


def test_smoke_dense_headline_on_the_cpu(monkeypatch):
    """chip_smoke.dense_headline at a tiny size on the CPU (n % 2048 !=
    0): the operators built at float32 (the packed one with
    ``use_kernels=True``, the kernels' plain versions), the card's
    timers and memory counters stubbed, stronger ucca effects
    (UCCA_BETA 0.2, as the project/ucca rehearsal): the dense result
    holds against the packed run on the same bytes, X is held in place,
    and no launch is counted on the dense operator."""
    import functools
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    monkeypatch.setattr(cs, "event_ms", lambda fn, reps: [fn(), 1.0][1])
    monkeypatch.setattr(cs, "UCCA_BETA", 0.2)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda: 0)
    monkeypatch.setattr(ft, "PackedOperator", functools.partial(
        ft.ops.operator.PackedOperator, dtype=torch.float32,
        use_kernels=True))
    monkeypatch.setattr(ft, "DenseOperator", functools.partial(
        ft.ops.operator.DenseOperator, dtype=torch.float32))
    out = cs.dense_headline(torch.device("cpu"), "a CPU", n=2101, p=700,
                            k=8)
    assert out["launches"] == 0 and out["check_mse"] < 1e-8
    assert out["check_mse_through_packed"] < 1e-8
    assert out["eig_err_of_largest"] <= 1e-6 and out["min_held"] >= 1 - 1e-6
    assert out["n_ops"] > 0 and out["packed_n_ops"] > 0
    assert max(out["ucca_causal_p"]) < 1e-8
