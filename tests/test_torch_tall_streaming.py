"""The port's TallStreamingOperator (the tall gram X^T X with the packed
bytes left on the host and staged in blocks of samples) against the JAX
package's TallStreamingOperator, the port's resident TallPackedOperator
and a float64 dense oracle; its entry points (``pca``, ``check``, the
CLI's ``--opmode tall --stream on``) against the JAX package's.

The fileset: n = 1203 (n % 4 == 3, so the last byte carries garbage
sample positions that every product must mask), p = 261, four
populations of unequal size, 3% missing calls, an all-missing and a
constant SNP.  Its 301 bytes a SNP run in three blocks of
``block_bytes=128`` (the last 45 bytes): a multiple of 128, so the JAX
package's Pallas path blocks the bytes as the port and its jnp path do.

Tolerances, with their reasons:

* float64 products against the JAX operator, the resident one and the
  dense oracle: 1e-12 relative (the same math in another order).
* the two-float gram (hi + lo in float64) against float64 X^T X v, and
  against the interpreted Pallas one: 5e-6 relative in norm (the bar of
  tests/test_torch_tall.py's ``test_gram_tall_ff_plain_matches_pallas``
  for pairs).  Its hi half is compared through the pair only, as
  tests/test_torch_streaming.py compares the wide fold: folded across
  blocks, a hi half carries the rounding of the blocks' partials (up to
  an ulp of the largest), not of the sum alone.
* float32 products through the kernels' plain versions against the
  resident operator's: 1e-5 relative in norm (another block order).
* ``pca`` at float64: equal ``n_ops`` and eigenvalues within 1e-10
  relative, vectors to a sign-invariant RMSE < 1e-8; at float32 with
  ``polish="contract"``: eigenvalues rtol 2e-6 and vector RMSE < 1e-6
  against the JAX package's (``test_tall_pca_float32_contract_matches_jax``'s
  bars).
* staging: prefetch on and off, and any block cache, give the same
  products bit for bit (the same blocks summed in the same order).
* ``crossprod`` (z = X^T x): at float64 within 1e-12 of each column's
  largest |z| against the JAX operator, the dense oracle and a 2-shard
  mesh; at float32 through the kernels' plain versions within 1e-5 of
  it against the JAX operator's interpreted Pallas B1 and float64 (a
  float32 sum over n samples, in another block order).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.cli import main as jmain
from flashpca_tpu.io.plink import PlinkDataset as JPlinkDataset
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.ops.operator import \
    TallStreamingOperator as JTallStreaming
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.io.plink import PlinkDataset as TPlinkDataset
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops.genotypes import dense_standardized_np
from flashpca_tpu_torch.ops.operator import (
    TallPackedOperator, TallStreamingOperator, packed_operator_from_numpy,
    tall_streaming_operator_from_numpy)

torch.set_num_threads(2)

K = 4
BB = 128
# the JAX TallStreamingOperator.stats() keys and the wide port's
STATS = ("fill_s", "put_s", "sync_s", "wait_s", "staged_bytes", "nops",
         "staged_host_blocks", "n_blocks", "n_cached", "block_bytes",
         "packed_bytes", "device_bytes", "prefetch")


@pytest.fixture(scope="module")
def fs(tmp_path_factory):
    rng = np.random.default_rng(41)
    n, p, pops = 1203, 261, 4
    w = 0.7 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.15, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)   # (n, p)
    geno[rng.uniform(size=geno.shape) < 0.03] = np.nan
    geno[:, 7] = np.nan                                # all missing
    geno[:, 9] = 2.0                                   # constant
    root = str(tmp_path_factory.mktemp("tallstream") / "t")
    write_bed(root, geno)
    ds = JPlinkDataset.open(root)
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    X = dense_standardized_np(ds.read_codes(), mean, sd).T     # (n, p)
    return dict(root=root, n=n, p=p, packed=ds.read_packed(), mean=mean,
                sd=sd, sumsq=sumsq, X=X, jds=ds,
                tds=TPlinkDataset.open(root))


def _stream(fs, **kw):
    kw.setdefault("block_bytes", BB)
    kw.setdefault("device", "cpu")
    return TallStreamingOperator(fs["tds"], fs["mean"], fs["sd"], fs["n"],
                                 **kw)


def _resident(fs, **kw):
    return TallPackedOperator(fs["packed"], fs["mean"], fs["sd"], fs["n"],
                              device="cpu", **kw)


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy()


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rmse(U, V):
    U, V = np.asarray(U), np.asarray(V)
    return max(min(np.linalg.norm(U[:, j] - V[:, j]),
                   np.linalg.norm(U[:, j] + V[:, j]))
               for j in range(U.shape[1])) / np.sqrt(U.shape[0])


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["inline", "prefetch"])
def test_products_match_jax_and_resident(fs, prefetch):
    rng = np.random.default_rng(3)
    X = fs["X"]
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], fs["n"],
                         block_bytes=BB, dtype=jnp.float64, use_pallas=False)
    top = _stream(fs, prefetch=prefetch)
    rop = _resident(fs)
    assert (top.block_bytes, top.n_blocks) == (jop.block_bytes,
                                               jop.n_blocks) == (BB, 3)
    assert top.op_dim == fs["p"] and not top.supports_ff
    v = rng.standard_normal((fs["p"], 3))
    gram = _np(top.gram_permuted(top.permute(v)))
    for want in (np.asarray(jop.gram_permuted(jop.permute(v))),
                 _np(rop.gram_permuted(rop.permute(v))), X.T @ (X @ v)):
        assert _rel(gram, want) < 1e-12
    y = _np(top.prod(v))
    assert y.shape == (fs["n"], 3)
    for want in (np.asarray(jop.prod(v)), _np(rop.prod(v)), X @ v):
        assert _rel(y, want) < 1e-12
    # vector inputs
    assert _rel(_np(top.gram_permuted(top.permute(v[:, 0]))),
                gram[:, 0]) < 1e-12
    assert _rel(_np(top.prod(v[:, 1])), y[:, 1]) < 1e-12
    # snp_sumsq and trace: the blocks' partials summed in float64
    np.testing.assert_allclose(top.snp_sumsq, jop.snp_sumsq, rtol=1e-12)
    np.testing.assert_allclose(top.snp_sumsq, (X ** 2).sum(0), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(top.trace, rop.trace, rtol=1e-12)
    st = top.stats()
    assert set(STATS) <= set(st) and st["prefetch"] is prefetch
    # four products and the sums-of-squares pass, each staging every block
    assert st["staged_host_blocks"] == 5 * top.n_blocks
    assert st["staged_bytes"] == 5 * fs["packed"].size
    assert st["nops"] == 4 and st["n_cached"] == 0
    assert st["block_bytes"] == fs["p"] * BB
    assert st["packed_bytes"] == fs["packed"].size
    assert st["device_bytes"] == 0                      # on the CPU
    top.reset_stats()
    assert top.stats()["staged_bytes"] == 0 and top.nops == 0


def test_prefetch_on_and_off_give_equal_products(fs):
    """The prefetch worker changes when a block is filled, not what the
    products sum: float32 through the kernels' plain versions, bit for
    bit, and within 1e-5 of the resident operator's."""
    rng = np.random.default_rng(4)
    f32 = dict(dtype=torch.float32, use_kernels=True)
    ops = [_stream(fs, prefetch=pf, **f32) for pf in (False, True)]
    rop = _resident(fs, **f32)
    v = torch.as_tensor(rng.standard_normal((fs["p"], 5)),
                        dtype=torch.float32)
    for name in ("gram_permuted", "gram_ff_permuted", "prod"):
        a, b = (getattr(op, name)(v) for op in ops)
        want = getattr(rop, name)(v)
        if name == "gram_ff_permuted":
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            a, want = a[0].double() + a[1].double(), (want[0].double()
                                                      + want[1].double())
        else:
            assert torch.equal(a, b)
        assert _rel(_np(a), _np(want)) < 1e-5


@pytest.mark.parametrize("k", [3, 28])
def test_gram_ff_matches_jax_interpret_and_float64(fs, k):
    """The two-float gram, per block B5, the mask, B3 and B1 folded by
    TwoSum, against the JAX operator's with interpreted Pallas kernels on
    the same 128-byte blocks, and both against float64 X^T X v."""
    X = fs["X"]
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], fs["n"],
                         block_bytes=BB, dtype=jnp.float32,
                         use_pallas="interpret")
    top = _stream(fs, dtype=torch.float32, use_kernels=True)
    assert top.supports_ff and jop.supports_ff
    assert (top.n_blocks, top.block_bytes) == (jop.n_blocks, jop.block_bytes)
    v = np.random.default_rng(10 + k).standard_normal(
        (fs["p"], k)).astype(np.float32)
    tpk.reset_launch_counts()
    th, tl = top.gram_ff_permuted(top.permute(v))
    jh, jl = (np.asarray(a)[: fs["p"]]
              for a in jop.gram_ff_permuted(jop.permute(jnp.asarray(v))))
    ref = X.T @ (X @ v.astype(np.float64))
    got = th.double().numpy() + tl.double().numpy()
    jax_ = jh.astype(np.float64) + jl
    assert _rel(got, ref) < 5e-6 and _rel(jax_, ref) < 5e-6
    assert np.linalg.norm(got - jax_) / np.linalg.norm(ref) < 5e-6
    # tensors on the CPU take the plain versions: no CUDA launch
    assert set(tpk.launch_counts.values()) == {0}
    # the float64 functional core has no tall two-float composition
    with pytest.raises(NotImplementedError, match="kernel wrappers"):
        _stream(fs).gram_ff_permuted(torch.zeros(fs["p"], 2,
                                                 dtype=torch.float64))


def test_pca_float64_matches_jax(fs):
    """Streamed tall pca() against the JAX package's, each on a prebuilt
    operator of the same 128-byte blocks, and from the fileset with
    streaming=True (one ~1 GiB block in both)."""
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], fs["n"],
                         block_bytes=BB, dtype=jnp.float64, use_pallas=False)
    rj = fj.pca(jop, K, do_loadings=True)
    rt = ft.pca(_stream(fs), K, do_loadings=True)
    assert (rt.n_ops, rt.n_restarts) == (rj.n_ops, rj.n_restarts)
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-10)
    assert _rmse(rt.vectors, rj.vectors) < 1e-8
    assert _rmse(rt.loadings, rj.loadings) < 1e-8
    np.testing.assert_allclose(rt.pve, rj.pve, rtol=1e-10)
    kw = dict(operator_mode="tall", streaming=True)
    rj2 = fj.pca(fs["root"], K, dtype=jnp.float64, **kw)
    rt2 = ft.pca(fs["root"], K, device="cpu", **kw)
    assert rt2.n_ops == rj2.n_ops
    np.testing.assert_allclose(rt2.values, rj2.values, rtol=1e-10)
    np.testing.assert_allclose(rt2.values, rt.values, rtol=1e-10)


def test_pca_float32_contract_matches_jax(fs):
    """float32 with polish="contract": the compensated polish runs through
    the tall two-float gram per block (the kernels' plain versions),
    against the JAX operator's interpreted Pallas kernels."""
    n, p = fs["n"], fs["p"]
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], n, block_bytes=BB,
                         dtype=jnp.float32, use_pallas="interpret")
    rj = fj.pca(jop, K)
    top = _stream(fs, dtype=torch.float32, use_kernels=True)
    tpk.reset_launch_counts()
    rt = ft.pca(top, K, polish="contract")
    np.testing.assert_allclose(rt.values, rj.values, rtol=2e-6)
    assert _rmse(rt.vectors, rj.vectors) < 1e-6
    assert rt.converged and top.nops > rt.n_ops
    assert set(tpk.launch_counts.values()) == {0}
    # check() of the result through a wide operator on the same bytes
    wide = packed_operator_from_numpy(fs["packed"], fs["mean"], fs["sd"], n,
                                      device="cpu", dtype=torch.float32,
                                      use_kernels=True)
    assert ft.check(wide, rt.vectors, rt.values).mse < 1e-10
    X = fs["X"]
    lam = np.linalg.eigvalsh(X.T @ X / p)[::-1][:K]
    np.testing.assert_allclose(rt.values, lam, rtol=2e-6)


@pytest.mark.parametrize("n", [52, 53, 54, 55])
def test_all_n_mod_4_paddings(tmp_path, n):
    """Every n % 4 residue, in blocks of 4 bytes with a narrower last
    one: the padding bits of the last byte never leak into a product."""
    rng = np.random.default_rng(200 + n)
    p = 9
    geno = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.07] = np.nan
    root = str(tmp_path / f"pad{n}")
    write_bed(root, geno)
    ds = TPlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    op = TallStreamingOperator(ds, mean, sd, n, block_bytes=4, device="cpu")
    assert op.n_blocks == 4 and op.nbytes % 4
    v = rng.normal(size=(p, 2))
    np.testing.assert_allclose(_np(op.gram_permuted(op.permute(v))),
                               X.T @ (X @ v), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(op.prod(v)), X @ v, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(op.trace, float(np.sum(X * X)), rtol=1e-12)
    f32 = TallStreamingOperator(ds, mean, sd, n, block_bytes=4,
                                device="cpu", dtype=torch.float32,
                                use_kernels=True)
    hi, lo = f32.gram_ff_permuted(f32.permute(v.astype(np.float32)))
    assert _rel(_np(hi) + _np(lo),
                X.T @ (X @ v.astype(np.float32).astype(np.float64))) < 5e-6


class TestBlockResidency:
    """The device block cache (a pinned prefix of the blocks) and the
    rotation, as the wide operator's TestBlockResidency."""

    def test_full_cache_stages_once(self, fs):
        rng = np.random.default_rng(6)
        op = _stream(fs, cache_mb=64)                  # covers everything
        ref = _stream(fs, cache_mb=0)
        assert op.stats()["n_cached"] == op.n_blocks == 3
        v = torch.as_tensor(rng.standard_normal((fs["p"], 2)))
        ys = [_np(op.gram_permuted(v)) for _ in range(3)]
        # the first product staged every block once; the others none
        assert op.staged_host_blocks == op.n_blocks
        yr = _np(ref.gram_permuted(v))
        _np(ref.gram_permuted(v))
        assert ref.staged_host_blocks == 2 * ref.n_blocks
        for y in ys:
            np.testing.assert_array_equal(y, yr)

    @pytest.mark.parametrize("prefetch", [False, True],
                             ids=["inline", "prefetch"])
    def test_partial_cache_parity_and_counts(self, fs, prefetch):
        rng = np.random.default_rng(7)
        op = _stream(fs, cache_mb=0)
        op1 = _stream(fs, prefetch=prefetch)
        # toy blocks are far below MB granularity: pin one block
        # directly to exercise the partial cache
        op1._n_cached = 1
        v = torch.as_tensor(rng.standard_normal((fs["p"], 3)))
        ya, yb = _np(op1.gram_permuted(v)), _np(op1.gram_permuted(v))
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(yb, _np(op.gram_permuted(v)))
        assert op1.staged_host_blocks == op1.n_blocks + (op1.n_blocks - 1)
        np.testing.assert_array_equal(_np(op1.prod(v)), _np(op.prod(v)))
        # every block once, then the two uncached ones twice
        assert op1.stats()["staged_bytes"] == fs["p"] * (
            op1.nbytes + 2 * (op1.nbytes - BB))
        op1.reset_stats()
        assert op1.stats()["staged_bytes"] == 0 and op1.nops == 0
        assert op1.stats()["n_cached"] == 1

    def test_stopped_product_leaves_the_rotation_sound(self, fs):
        """A product abandoned mid-pass (its generator closed early) must
        leave no fill running into a buffer the next product uses."""
        rng = np.random.default_rng(8)
        op = _stream(fs, prefetch=True)
        ref = _stream(fs, prefetch=False)
        blocks = op._blocks()
        for _ in range(2):
            next(blocks)
        blocks.close()
        v = torch.as_tensor(rng.standard_normal((fs["p"], 2)))
        np.testing.assert_array_equal(_np(op.gram_permuted(v)),
                                      _np(ref.gram_permuted(v)))
        op.close()
        op.close()                                       # idempotent
        np.testing.assert_array_equal(_np(op.prod(v)), _np(ref.prod(v)))


def test_memory_mb_bounds_block_bytes(fs):
    """--memory semantics, as the JAX package's
    test_tall_streaming_memory_mb_bounds_block: the budget sizes the
    staged block to two device buffers and turns the automatic cache
    off; the geometry is the JAX package's on its jnp path."""
    p, nbytes = fs["p"], fs["packed"].shape[1]
    for kw in (dict(memory_mb=1), dict(), dict(block_bytes=7),
               dict(block_bytes=2)):
        jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], fs["n"],
                             dtype=jnp.float64, use_pallas=False, **kw)
        top = _stream(fs, **{"block_bytes": None, **kw})
        assert (top.block_bytes, top.n_blocks) == (jop.block_bytes,
                                                   jop.n_blocks), kw
        assert top.block_bytes % 4 == 0 and top.block_bytes <= nbytes
    mop = _stream(fs, block_bytes=None, memory_mb=1)
    assert 2 * p * mop.block_bytes <= 1 << 20
    assert (mop.block_bytes, mop.n_blocks) == (300, 2)   # the last: 1 byte
    assert mop._resolve_cache_blocks() == 0
    assert _stream(fs, block_bytes=7).block_bytes == 4
    assert _stream(fs, block_bytes=2).block_bytes == 4


def test_block_size_raises_as_in_jax(fs):
    """block_size counts SNPs a block (the wide axis); the tall streaming
    path blocks the samples, so both packages refuse it (JAX
    test_tall_streaming_rejects_block_size)."""
    kw = dict(operator_mode="tall", streaming=True, block_size=512)
    with pytest.raises(ValueError, match="memory_mb") as jerr:
        fj.pca(fs["root"], 2, **kw)
    with pytest.raises(ValueError, match="memory_mb") as terr:
        ft.pca(fs["root"], 2, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_prebuilt_conflicts(fs):
    """A prebuilt TallStreamingOperator is a streaming operator for the
    conflict checks and dispatches to the tall solve (JAX
    test_tall_streaming_prebuilt_conflicts)."""
    op = _stream(fs, cache_mb=0)
    with pytest.raises(ValueError, match="streaming=False"):
        ft.pca(op, 2, streaming=False)
    with pytest.raises(ValueError, match="operator_mode"):
        ft.pca(op, 2, operator_mode="wide")
    with pytest.raises(ValueError, match="memory_mb"):
        ft.pca(op, 2, memory_mb=1)
    with pytest.raises(ValueError, match="block_size"):
        ft.pca(op, 2, block_size=8)
    with pytest.raises(ValueError, match="TallStreamingOperator"):
        ft.pca(_resident(fs), 2, streaming=True)
    X = fs["X"]
    w = np.linalg.eigvalsh(X.T @ X / fs["p"])[::-1][:3]
    res = ft.pca(op, 3, tol=1e-9, streaming=True, operator_mode="tall")
    np.testing.assert_allclose(res.values, w, rtol=1e-8)


def test_check_with_the_tall_streaming_operator_raises(fs):
    """check() verifies the wide decomposition; both packages refuse a
    tall streaming operator."""
    n = fs["n"]
    for op in (_stream(fs),
               JTallStreaming(fs["jds"], fs["mean"], fs["sd"], n,
                              block_bytes=BB, dtype=jnp.float64,
                              use_pallas=False)):
        check = ft.check if isinstance(op, TallStreamingOperator) else \
            fj.check
        with pytest.raises(ValueError, match="WIDE decomposition"):
            check(op, np.zeros((n, 2)), np.ones(2))


def test_tall_streaming_operator_from_numpy(fs):
    """The port's operator from the JAX one's numpy state."""
    rng = np.random.default_rng(9)
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], fs["n"],
                         block_bytes=BB, dtype=jnp.float64, use_pallas=False)
    top = tall_streaming_operator_from_numpy(
        jop._host_packed, jop.center, jop.scale, jop.n_samples,
        block_bytes=jop.block_bytes, device="cpu")
    assert isinstance(top, ft.TallStreamingOperator)
    assert (top.block_bytes, top.n_blocks) == (jop.block_bytes, jop.n_blocks)
    v = rng.standard_normal((fs["p"], 2))
    assert _rel(_np(top.gram_permuted(top.permute(v))),
                np.asarray(jop.gram_permuted(jop.permute(v)))) < 1e-12
    with pytest.raises(ValueError, match="width"):
        tall_streaming_operator_from_numpy(fs["packed"][:, :-1], fs["mean"],
                                           fs["sd"], fs["n"], device="cpu")


def test_streamed_state_out_resumes_resident(fs, tmp_path):
    """A streamed tall run's checkpoint (SNP-space Ritz panel) resumes on
    the resident tall operator (JAX test_tall_streaming_checkpoint_resume)."""
    root = fs["root"]
    state = str(tmp_path / "ritz.npz")
    with pytest.raises(RuntimeError, match="not successful"):
        ft.pca(root, 3, tol=1e-12, maxiter=1, operator_mode="tall",
               streaming=True, state_out=state, device="cpu")
    warm = ft.pca(root, 3, tol=1e-9, operator_mode="tall", state_in=state,
                  device="cpu")
    ref = ft.pca(root, 3, tol=1e-9, operator_mode="tall", device="cpu")
    np.testing.assert_allclose(warm.values, ref.values, rtol=1e-7)
    for j in range(3):
        assert abs(np.dot(warm.vectors[:, j], ref.vectors[:, j])) > 1 - 1e-7


def _cli(fn, args, cwd):
    """Run a CLI's main in ``cwd``; returns (exit code, stderr)."""
    old = os.getcwd()
    os.chdir(cwd)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = fn(args)
    finally:
        os.chdir(old)
    return rc, err.getvalue()


def test_cli_stream_on_writes_what_stream_off_and_jax_write(fs, tmp_path):
    """``--opmode tall --stream on`` writes the files ``--stream off``
    writes, and the JAX CLI's on the same arguments: the same files,
    rows and columns; at float64 the numbers agree to the text's seven
    significant digits (values rtol 1e-6, vectors sign-invariant RMSE
    < 1e-6, as test_torch_tall.py's CLI test)."""
    common = ["--bfile", fs["root"], "--ndim", str(K), "--opmode", "tall",
              "--outload", "loadings.txt", "--notime"]
    runs = {"on": (tmain, ["--device", "cpu", "--stream", "on"]),
            "off": (tmain, ["--device", "cpu", "--stream", "off"]),
            "jax": (jmain, ["--dtype", "float64", "--shards", "1",
                            "--stream", "on"])}
    for name, (fn, extra) in runs.items():
        d = tmp_path / name
        d.mkdir()
        rc, err = _cli(fn, common + extra, d)
        assert rc == 0 and "Exception" not in err, err
    files = ("eigenvalues.txt", "pve.txt", "eigenvectors.txt", "pcs.txt",
             "loadings.txt")
    for other in ("off", "jax"):
        for f in files:
            assert (tmp_path / other / f).exists(), f
            a = np.loadtxt(tmp_path / "on" / f, dtype=str)
            b = np.loadtxt(tmp_path / other / f, dtype=str)
            assert a.shape == b.shape, f
            if f in ("eigenvalues.txt", "pve.txt"):
                np.testing.assert_allclose(a.astype(float), b.astype(float),
                                           rtol=1e-6)
            else:
                assert np.array_equal(a[:, :2], b[:, :2]), f    # row names
                assert _rmse(a[1:, 2:].astype(float),
                             b[1:, 2:].astype(float)) < 1e-6, f


@pytest.mark.parametrize("flags", [["--memory", "3"], ["--blocksize", "10"]],
                         ids=["memory", "blocksize"])
def test_cli_memory_ends_as_jax(fs, tmp_path, flags):
    """``--opmode tall --stream on --memory M``: the JAX CLI turns
    ``--memory`` into a SNP block size, which its tall streaming path
    refuses; the port's CLI ends the same way -- exit code 1, the same
    message -- and writes no result."""
    args = ["--bfile", fs["root"], "--ndim", "3", "--opmode", "tall",
            "--stream", "on", "--notime"] + flags
    ends = []
    for fn, extra, d in ((jmain, ["--dtype", "float64"], "jax"),
                         (tmain, ["--device", "cpu"], "port")):
        (tmp_path / d).mkdir()
        ends.append(_cli(fn, args + extra, tmp_path / d))
        assert not (tmp_path / d / "eigenvalues.txt").exists()
    (jrc, jerr), (trc, terr) = ends
    assert trc == jrc == 1
    assert terr == jerr and "does not apply to the tall streaming" in terr


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_tall_same_order_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's tall same-order phase, rehearsed at tiny sizes with
    the kernels' plain versions standing in for the kernels (no launches
    to count here): every configuration's products bit-equal to their
    same-order references, a ragged last block, n % 4 != 0 and a .bed
    memmap among them, and the staging counts right."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    cases = (("aligned", 40, 400, 24, {"block_bytes": 20}, False),
             ("odd", 23, 101, 25, {"block_bytes": 8}, False),
             ("memmap", 17, 203, 26, {"block_bytes": 12}, True))
    out = cs.check_tall_streamed(torch.device("cpu"), str(tmp_path), cases,
                                 dtype=torch.float32, use_kernels=True)
    assert len(out) == len(cases) * len(cs.STREAM_CONFIGS)
    assert out["odd/1/0"]["n_blocks"] == 4
    assert out["odd/1/0"]["last_block_bytes"] == 2
    assert out["memmap/0/0"]["memmap"] and out["memmap/0/0"]["n_blocks"] == 5
    # twelve products, the first staging every block, each later one the
    # uncached blocks
    assert out["aligned/1/3"]["staged_host_blocks"] == 5 + 11 * 2


def _col_err(got, want):
    """Largest error of each column over that column's largest |want|."""
    got = np.asarray(got, dtype=np.float64).reshape(len(want), -1)
    want = np.asarray(want, dtype=np.float64).reshape(len(want), -1)
    return float(np.max(np.abs(got - want).max(0) / np.abs(want).max(0)))


@pytest.mark.parametrize("shape", ["vector", "panel"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_crossprod_matches_jax(fs, dtype, shape):
    """z = X^T x on the streamed blocks (the last one ragged) against the
    JAX TallStreamingOperator's on the same 128-byte blocks -- its jnp
    path at float64, its Pallas B1 interpreted at float32 -- and the
    dense oracle; one product counted a call."""
    n, X = fs["n"], fs["X"]
    rng = np.random.default_rng(11 if shape == "vector" else 12)
    x = rng.standard_normal(n if shape == "vector" else (n, 3))
    f64 = dtype == "float64"
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], n, block_bytes=BB,
                         dtype=jnp.float64 if f64 else jnp.float32,
                         use_pallas=False if f64 else "interpret")
    top = _stream(fs) if f64 else _stream(fs, dtype=torch.float32,
                                          use_kernels=True)
    assert top.n_blocks == 3 and top.nbytes % BB
    if not f64:
        x = x.astype(np.float32)
    tpk.reset_launch_counts()
    z = _np(top.crossprod(x))
    zj = np.asarray(jop.crossprod(jnp.asarray(x)))
    assert z.shape == zj.shape == ((fs["p"],) if shape == "vector"
                                   else (fs["p"], 3))
    assert top.nops == jop.nops == 1
    bar = 1e-12 if f64 else 1e-5
    assert _col_err(z, zj) < bar
    assert _col_err(z, X.T @ x.astype(np.float64)) < bar
    assert set(tpk.launch_counts.values()) == {0}
    top.crossprod(x)
    assert top.nops == 2 and top.stats()["nops"] == 2


def test_crossprod_wrong_leading_dim_raises_as_jax(fs):
    n = fs["n"]
    jop = JTallStreaming(fs["jds"], fs["mean"], fs["sd"], n, block_bytes=BB,
                         dtype=jnp.float64, use_pallas=False)
    top = _stream(fs)
    for bad in (np.zeros(n - 1), np.zeros((n + 4, 2)), np.zeros(fs["p"])):
        with pytest.raises(ValueError, match="crossprod: expected leading"):
            jop.crossprod(jnp.asarray(bad))
        with pytest.raises(ValueError, match="crossprod: expected leading"):
            top.crossprod(bad)
    assert top.nops == jop.nops == 0


@pytest.mark.parametrize("n", [52, 53, 54, 55])
def test_crossprod_every_n_mod_4(tmp_path, n):
    """Every n % 4 residue in blocks of 4 bytes with a narrower last one:
    x's rows past n never reach a product, at float64 against the JAX
    operator and float64 X^T x, and at float32 through the plain B1."""
    rng = np.random.default_rng(300 + n)
    p = 9
    geno = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.07] = np.nan
    root = str(tmp_path / f"cp{n}")
    write_bed(root, geno)
    ds = TPlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    jop = JTallStreaming(JPlinkDataset.open(root), mean, sd, n,
                         block_bytes=4, dtype=jnp.float64, use_pallas=False)
    op = TallStreamingOperator(ds, mean, sd, n, block_bytes=4, device="cpu")
    f32 = TallStreamingOperator(ds, mean, sd, n, block_bytes=4,
                                device="cpu", dtype=torch.float32,
                                use_kernels=True)
    assert op.n_blocks == jop.n_blocks == 4 and op.nbytes % 4
    for x in (rng.normal(size=n), rng.normal(size=(n, 2))):
        z = _np(op.crossprod(x))
        assert _col_err(z, np.asarray(jop.crossprod(jnp.asarray(x)))) < 1e-12
        assert _col_err(z, X.T @ x) < 1e-12
        x32 = x.astype(np.float32)
        assert _col_err(_np(f32.crossprod(x32)),
                        X.T @ x32.astype(np.float64)) < 1e-5


def test_crossprod_two_shards_match_unsharded(fs):
    """A 2-shard CPU mesh (each block split into two byte windows, as
    tests/test_torch_dist.py builds its sharded TallStreamingOperator):
    each window takes its own run of x, and the shards' partials sum to
    the unsharded z."""
    from flashpca_tpu_torch.parallel import snp_mesh

    rng = np.random.default_rng(13)
    x = rng.standard_normal((fs["n"], 4))
    one = _stream(fs, block_bytes=8)
    two = TallStreamingOperator(fs["tds"], fs["mean"], fs["sd"], fs["n"],
                                block_bytes=8,
                                mesh=snp_mesh(["cpu"] * 2,
                                              axis_name="samples"))
    # 301 bytes: 38 blocks, the last of 5 bytes split into 4 + 1
    assert two.nshards == 2 and len(two._items) == 2 * one.n_blocks == 76
    assert two._items[-1][:2] == (300, 301)
    z1, z2 = _np(one.crossprod(x)), _np(two.crossprod(x))
    assert _col_err(z2, z1) < 1e-12
    assert _col_err(_np(two.crossprod(x[:, 0])), z1[:, 0]) < 1e-12
    assert two.nops == 2


@pytest.fixture(scope="module")
def cache_fs(tmp_path_factory):
    """Blocks of about half a MB, so that an MB cache budget holds some
    of them: 4,000 samples (1,000 bytes a SNP) x 1,200 SNPs."""
    rng = np.random.default_rng(14)
    n, p = 4000, 1200
    root = str(tmp_path_factory.mktemp("cache") / "c")
    write_bed(root, rng.binomial(2, 0.3, size=(n, p)).astype(np.float64))
    jds = JPlinkDataset.open(root)
    mean, sd = jds.snp_stats("binom2")
    return dict(root=root, n=n, p=p, mean=mean, sd=sd, jds=jds,
                tds=TPlinkDataset.open(root))


@pytest.mark.parametrize("cache_mb", [0, 1, 2, 64])
@pytest.mark.parametrize("tall", [False, True], ids=["wide", "tall"])
def test_build_packed_operator_cache_mb(cache_fs, tall, cache_mb):
    """build_packed_operator(streaming=True, cache_mb=N) hands the budget
    to the streaming operator, which keeps as many leading blocks on the
    device as the JAX package's _resolve_cache_blocks does for N MB (0:
    none); the resident builds take the keyword and ignore it."""
    from flashpca_tpu.ops.operator import \
        build_packed_operator as jbuild
    from flashpca_tpu_torch.ops.operator import build_packed_operator

    c = cache_fs
    geo = dict(memory_mb=1) if tall else dict(block_size=600)
    top = build_packed_operator(c["tds"], c["mean"], c["sd"], tall=tall,
                                streaming=True, device="cpu",
                                cache_mb=cache_mb, **geo)
    assert isinstance(top, TallStreamingOperator if tall
                      else ft.StreamingPackedOperator)
    if tall:
        jop = JTallStreaming(c["jds"], c["mean"], c["sd"], c["n"],
                             dtype=jnp.float64, use_pallas=False,
                             cache_mb=cache_mb, **geo)
    else:
        jop = jbuild(c["jds"], c["mean"], c["sd"], streaming=True,
                     dtype=jnp.float64, cache_mb=cache_mb, **geo)
    n_cached = top.stats()["n_cached"]
    assert top.n_blocks == jop.n_blocks
    assert n_cached == jop._resolve_cache_blocks()
    assert n_cached == min(top.n_blocks,
                           (cache_mb << 20) // top.block_nbytes)
    want = {0: 0, 1: 2, 2: 3, 64: 3} if tall else {0: 0, 1: 1, 2: 2, 64: 2}
    assert (top.n_blocks, n_cached) == (3 if tall else 2, want[cache_mb])
    # a product stages every block once; the cached ones never again
    v = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (c["p"] if tall else c["n"], 2)))

    def gram(op):
        return _np(op.gram_permuted(v) if tall else op.perform_op(v))

    np.testing.assert_array_equal(gram(top), gram(top))
    assert top.staged_host_blocks == 2 * top.n_blocks - n_cached
    # the resident builds accept the keyword and ignore it
    res = build_packed_operator(c["tds"], c["mean"], c["sd"], tall=tall,
                                streaming=False, device="cpu",
                                cache_mb=cache_mb)
    ref = build_packed_operator(c["tds"], c["mean"], c["sd"], tall=tall,
                                streaming=False, device="cpu")
    assert type(res) is type(ref) is (TallPackedOperator if tall
                                      else ft.PackedOperator)
    np.testing.assert_array_equal(gram(res), gram(ref))


def test_smoke_tall_crossprod_step_on_the_cpu(monkeypatch):
    """chip_smoke.tall_crossprod rehearsed at 601 x 97 on the CPU: the
    operators at float32 through the kernels' plain versions, the card's
    sync and launch counts stubbed (the plain versions launch nothing):
    the vector and the panel each held to float64 and to the resident
    wide operator within CROSSPROD_BAR, the count checked once a call
    against the streamed blocks."""
    import functools

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    want = []
    monkeypatch.setattr(cs, "require_counts",
                        lambda launches, w, what: want.append(w))
    for name in ("PackedOperator", "TallStreamingOperator"):
        monkeypatch.setattr(ft, name, functools.partial(
            getattr(ft.ops.operator, name), dtype=torch.float32,
            use_kernels=True))
    dev = torch.device("cpu")
    n, p = 601, 97
    packed, mean, sd, _ = cs.card_data(dev, n, p, 3)
    host = packed.numpy()
    # memory_mb 0 gives the smallest blocks: one word of bytes each
    out = cs.tall_crossprod(dev, host, mean, sd, n, memory_mb=0,
                            f64_rows=64)
    n_blocks = -(-host.shape[1] // 4)
    assert want == [{"crossprod_narrow": n_blocks}, {"crossprod": n_blocks}]
    for k in cs.TALL_CROSSPROD_KS:
        assert out[k]["f64_err"] <= cs.CROSSPROD_BAR
        assert out[k]["wide_err"] <= cs.CROSSPROD_BAR
        assert out[k]["launches"] == 0               # the plain versions
