"""The port's StreamingPackedOperator (the wide gram with the packed
bytes left on the host and staged block by block) against the JAX
package's StreamingPackedOperator and the port's resident operator.

The JAX operators run on their jnp path (``use_pallas=False``).  Every
operator here is built with ``block_snps=16`` or ``memory_mb=1``, so the
products cross several blocks.  The fileset has n % 4 == 3, missing
calls and one constant SNP, as in tests/test_torch_operator.py.

Tolerances: float64 products agree to rtol 1e-10 / atol 1e-10 and the
trace to 1e-12 (the same sums in another grouping, test_operator.py's
bar); two-float grams, compared through hi + lo in float64, to 5e-6
relative in norm (test_torch_compensated.py's bar); float32 products
through the kernels' plain versions to 1e-5 relative in norm; ``pca``
eigenvalues to rtol 1e-8 and vectors to |cos| > 1 - 1e-8, ``check`` err
and mse to rtol 1e-8 (test_streaming_modes.py's bars).
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.io.plink import PlinkDataset as JPlinkDataset
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.ops.operator import \
    StreamingPackedOperator as JStreamingPackedOperator
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.io.plink import PlinkDataset as TPlinkDataset
from flashpca_tpu_torch.ops.genotypes import dense_standardized_np
from flashpca_tpu_torch.ops.operator import (PackedOperator,
                                             StreamingPackedOperator,
                                             build_packed_operator,
                                             resolve_streaming,
                                             streaming_operator_from_numpy)

torch.set_num_threads(2)

# the JAX StreamingPackedOperator.stats() keys, all kept by the port
JAX_STATS = ("fill_s", "put_s", "sync_s", "wait_s", "staged_bytes", "nops",
             "staged_host_blocks", "n_blocks", "n_cached", "block_bytes",
             "packed_bytes", "prefetch")


def _geno(rng, n, p, missing=0.03):
    freq = rng.uniform(0.05, 0.5, p)
    geno = rng.binomial(2, freq[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < missing] = np.nan
    return geno


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(31)
    n, p = 203, 150
    geno = _geno(rng, n, p)
    geno[:, 9] = 2.0                                    # a constant SNP
    root = str(tmp_path_factory.mktemp("stream") / "d")
    write_bed(root, geno)
    ds = JPlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T     # (n, p)
    return dict(root=root, n=n, p=p, packed=ds.read_packed(), mean=mean,
                sd=sd, X=X, jds=ds, tds=TPlinkDataset.open(root))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """21 x 30: too small for the default solver panel (as
    test_operator.py's small-problem case)."""
    rng = np.random.default_rng(9)
    n, p = 21, 30
    geno = rng.binomial(2, rng.uniform(0.2, 0.5, p)[None, :],
                        size=(n, p)).astype(np.float64)
    root = str(tmp_path_factory.mktemp("tiny") / "tiny")
    write_bed(root, geno)
    return root


def _stream(data, **kw):
    kw.setdefault("block_snps", 16)
    kw.setdefault("device", "cpu")
    return StreamingPackedOperator(data["tds"], data["mean"], data["sd"],
                                   data["n"], **kw)


def _resident(data, **kw):
    return PackedOperator(data["packed"], data["mean"], data["sd"],
                          data["n"], device="cpu", **kw)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy()


def _f64(a):
    return _np(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["inline", "prefetch"])
def test_products_match_jax_and_resident(data, prefetch):
    rng = np.random.default_rng(3)
    jop = JStreamingPackedOperator(data["jds"], data["mean"], data["sd"],
                                   data["n"], block_snps=16,
                                   dtype=jnp.float64, use_pallas=False)
    top = _stream(data, prefetch=prefetch)
    rop = _resident(data)
    assert top.n_blocks == jop.n_blocks > 1
    x = rng.standard_normal((data["n"], 3))
    v = rng.standard_normal((data["p"], 2))
    for name, arg in (("perform_op", x), ("crossprod", x), ("prod", v)):
        got = _np(getattr(top, name)(arg))
        for want in (np.asarray(getattr(jop, name)(arg)),
                     _np(getattr(rop, name)(arg))):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # vector inputs and the dense oracle
    xv = x[:, 0]
    np.testing.assert_allclose(_np(top.perform_op(xv)),
                               data["X"] @ (data["X"].T @ xv), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(top.trace, jop.trace, rtol=1e-12)
    np.testing.assert_allclose(top.trace, rop.trace, rtol=1e-12)
    st = top.stats()
    assert set(JAX_STATS) <= set(st) and st["prefetch"] is prefetch
    # three products and one trace pass, each staging every block
    assert st["staged_host_blocks"] == 5 * top.n_blocks
    assert st["staged_bytes"] == 5 * data["packed"].size
    assert st["nops"] == 4 and st["n_cached"] == 0


@pytest.mark.parametrize("kern", [False, True], ids=["core", "plain"])
def test_gram_ff_float32_matches_jax_and_resident(data, kern):
    rng = np.random.default_rng(4)
    f32 = torch.float32
    top = _stream(data, dtype=f32, use_kernels=kern)
    rop = _resident(data, dtype=f32, use_kernels=kern)
    jop = JStreamingPackedOperator(data["jds"], data["mean"], data["sd"],
                                   data["n"], block_snps=16,
                                   dtype=jnp.float32, use_pallas=False)
    x = rng.standard_normal((data["n"], 4)).astype(np.float32)
    xp = top.permute(x)
    pairs = [top.gram_ff_permuted(xp), rop.gram_ff_permuted(xp),
             jop.gram_ff_permuted(jop.permute(x))]
    got, res, jax_ = (_f64(h) + _f64(l) for h, l in pairs)
    X = data["X"]
    ref = top.permute_np(X @ (X.T @ x.astype(np.float64)))
    assert _rel(got, ref) < 5e-6
    assert np.linalg.norm(got - res) / np.linalg.norm(ref) < 5e-6
    assert np.linalg.norm(got - jax_) / np.linalg.norm(ref) < 5e-6
    # byte-padding positions stay exactly zero in both halves
    pad = _np(top._valid) == 0
    assert pad.any()
    assert not np.any(_np(pairs[0][0])[pad]) and not np.any(
        _np(pairs[0][1])[pad])
    assert top.supports_ff


def test_float32_kernel_plain_versions_match_resident(data):
    """float32 with use_kernels=True: the kernels' plain versions run per
    block, against the resident operator's plain versions."""
    rng = np.random.default_rng(5)
    top = _stream(data, dtype=torch.float32, use_kernels=True)
    rop = _resident(data, dtype=torch.float32, use_kernels=True)
    x = rng.standard_normal((data["n"], 5)).astype(np.float32)
    v = rng.standard_normal((data["p"], 5)).astype(np.float32)
    for name, arg in (("perform_op", x), ("crossprod", x), ("prod", v)):
        assert _rel(_np(getattr(top, name)(arg)),
                    _np(getattr(rop, name)(arg))) < 1e-5


@pytest.mark.parametrize("case", ["fileset", "tiny"])
def test_pca_streaming_matches_jax_and_resident(data, tiny, case):
    root = data["root"] if case == "fileset" else tiny
    kw = dict(tol=1e-9, streaming=True, memory_mb=1)
    got = ft.pca(root, 3, device="cpu", **kw)
    for want in (fj.pca(root, 3, **kw),
                 ft.pca(root, 3, tol=1e-9, streaming=False, device="cpu")):
        np.testing.assert_allclose(got.values, want.values, rtol=1e-8)
        for j in range(3):
            c = abs(np.dot(got.vectors[:, j], np.asarray(want.vectors[:, j])))
            assert c > 1 - 1e-8


def test_check_streaming_matches_resident_and_jax(data):
    root = data["root"]
    res = ft.pca(root, 3, tol=1e-9, device="cpu")
    got = ft.check(root, res.vectors, res.values, streaming=True,
                   memory_mb=1, device="cpu")
    for want in (ft.check(root, res.vectors, res.values, streaming=False,
                          device="cpu"),
                 fj.check(root, res.vectors, res.values, streaming=True,
                          memory_mb=1)):
        np.testing.assert_allclose(got.err, want.err, rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(got.mse, want.mse, rtol=1e-8, atol=1e-16)
    assert got.mse < 1e-10
    # a prebuilt streaming operator of the same geometry, and the
    # conflicts it rejects
    op = _stream(data, block_snps=None, memory_mb=1)
    np.testing.assert_allclose(
        ft.check(op, res.vectors, res.values).mse, got.mse, rtol=1e-8)
    with pytest.raises(ValueError, match="streaming=False"):
        ft.check(op, res.vectors, res.values, streaming=False)
    with pytest.raises(ValueError, match="memory_mb"):
        ft.pca(op, 3, memory_mb=1)
    with pytest.raises(ValueError, match="operator_mode"):
        ft.pca(op, 3, operator_mode="tall")
    with pytest.raises(ValueError, match="streaming=True"):
        ft.pca(_resident(data), 3, streaming=True)
    pres = ft.pca(op, 3, tol=1e-9, streaming=True)
    np.testing.assert_allclose(pres.values, res.values, rtol=1e-8)


class TestBlockResidency:
    """The device block cache (a pinned prefix of the blocks), as the
    JAX package's TestBlockResidency (test_streaming_modes.py)."""

    def test_full_cache_stages_once(self, data):
        rng = np.random.default_rng(6)
        op = _stream(data, cache_mb=64)                # covers everything
        ref = _stream(data, cache_mb=0)
        assert op.n_blocks > 1 and op.stats()["n_cached"] == op.n_blocks
        x = rng.standard_normal((data["n"], 2))
        ys = [_np(op.perform_op(x)) for _ in range(3)]
        # the first product staged every block once; the others none
        assert op.staged_host_blocks == op.n_blocks
        yr = _np(ref.perform_op(x))
        assert ref.staged_host_blocks == ref.n_blocks
        _np(ref.perform_op(x))
        assert ref.staged_host_blocks == 2 * ref.n_blocks
        for y in ys:
            np.testing.assert_array_equal(y, yr)

    @pytest.mark.parametrize("prefetch", [False, True],
                             ids=["inline", "prefetch"])
    def test_partial_cache_parity_and_counts(self, data, prefetch):
        rng = np.random.default_rng(7)
        op = _stream(data, cache_mb=0)
        op1 = _stream(data, prefetch=prefetch)
        # toy blocks are far below MB granularity: pin two blocks
        # directly to exercise the partial cache
        op1._n_cached = 2
        x = rng.standard_normal((data["n"], 3))
        ya, yb = _np(op1.perform_op(x)), _np(op1.perform_op(x))
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(yb, _np(op.perform_op(x)))
        assert op1.staged_host_blocks == op1.n_blocks + (op1.n_blocks - 2)
        v = rng.standard_normal((data["p"], 2))
        np.testing.assert_array_equal(_np(op1.crossprod(x)),
                                      _np(op.crossprod(x)))
        np.testing.assert_array_equal(_np(op1.prod(v)), _np(op.prod(v)))
        op1.reset_stats()
        assert op1.stats()["staged_bytes"] == 0 and op1.nops == 0
        assert op1.stats()["n_cached"] == 2

    def test_stopped_product_leaves_the_rotation_sound(self, data):
        """A product abandoned mid-pass (its generator closed early) must
        leave no fill running into a buffer the next product uses."""
        rng = np.random.default_rng(8)
        op = _stream(data, prefetch=True)
        ref = _stream(data, prefetch=False)
        blocks = op._blocks()
        for _ in range(3):
            next(blocks)
        blocks.close()
        x = rng.standard_normal((data["n"], 2))
        np.testing.assert_array_equal(_np(op.perform_op(x)),
                                      _np(ref.perform_op(x)))
        op.close()
        op.close()                                       # idempotent
        np.testing.assert_array_equal(_np(op.perform_op(x)),
                                      _np(ref.perform_op(x)))


@pytest.mark.parametrize("n", [60, 61, 62, 63])
def test_all_n_mod_4_paddings(tmp_path, n):
    """Every n % 4 residue: the padding bits in the last byte never leak
    into a streamed product."""
    rng = np.random.default_rng(100 + n)
    p = 23
    geno = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.07] = np.nan
    root = str(tmp_path / f"pad{n}")
    write_bed(root, geno)
    ds = TPlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    op = StreamingPackedOperator(ds, mean, sd, n, block_snps=5, device="cpu")
    assert op.n_blocks == 5
    x = rng.normal(size=(n, 2))
    v = rng.normal(size=(p, 2))
    np.testing.assert_allclose(_np(op.perform_op(x)), X @ (X.T @ x),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_np(op.crossprod(x)), X.T @ x, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(op.prod(v)), X @ v, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(op.trace, float(np.sum(X * X)), rtol=1e-12)
    hi, lo = op.perform_op_ff(x.astype(np.float32))
    assert _rel(_np(hi) + _np(lo), X @ (X.T @ x.astype(np.float32))) < 5e-6


def test_streaming_operator_from_numpy(data):
    """The port's operator from the JAX one's numpy state."""
    rng = np.random.default_rng(9)
    jop = JStreamingPackedOperator(data["jds"], data["mean"], data["sd"],
                                   data["n"], memory_mb=1,
                                   dtype=jnp.float64, use_pallas=False)
    top = streaming_operator_from_numpy(
        jop._host_packed, jop.center, jop.scale, jop.n_samples,
        block_snps=jop.block_snps, device="cpu")
    assert isinstance(top, ft.StreamingPackedOperator)
    assert (top.block_snps, top.n_blocks) == (jop.block_snps, jop.n_blocks)
    # memory_mb's geometry is the JAX package's on the jnp path
    mop = _stream(data, block_snps=None, memory_mb=1)
    assert (mop.block_snps, mop.n_blocks) == (jop.block_snps, jop.n_blocks)
    x = rng.standard_normal((data["n"], 2))
    np.testing.assert_allclose(_np(top.perform_op(x)),
                               np.asarray(jop.perform_op(x)), rtol=1e-10,
                               atol=1e-10)
    with pytest.raises(ValueError, match="width"):
        streaming_operator_from_numpy(data["packed"][:, :-1], data["mean"],
                                      data["sd"], data["n"], device="cpu")


def _stub_card(monkeypatch, total):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=total))


def test_resolve_streaming_on_a_stubbed_card(data, monkeypatch):
    ds = data["tds"]
    packed = ds.n_snps * ds.nbytes_per_snp
    # on the CPU "auto" never streams, whatever the size
    assert resolve_streaming("auto", ds, "cpu") is False
    assert resolve_streaming(True, ds, "cpu") is True
    assert resolve_streaming(False, ds, "cuda") is False
    # a card on which the bytes exceed 0.7 x its memory: stream
    _stub_card(monkeypatch, int(packed / 0.7) - 1)
    assert resolve_streaming("auto", ds) is True
    assert resolve_streaming("auto", ds, "cuda") is True
    # one that holds them below 0.7 x: resident
    _stub_card(monkeypatch, int(packed / 0.7) + 2)
    assert resolve_streaming("auto", ds) is False
    # the tall path streams too: an explicit request, and an over-size
    # "auto" builds the tall streaming operator, never a resident one
    # that cannot fit
    res = ft.pca(data["root"], 3, device="cpu", operator_mode="tall",
                 streaming=True, tol=1e-9)
    want = ft.pca(data["root"], 3, device="cpu", operator_mode="tall",
                  streaming=False, tol=1e-9)
    np.testing.assert_allclose(res.values, want.values, rtol=1e-10)
    from flashpca_tpu_torch.ops import operator as top

    built = []
    monkeypatch.setattr(top, "TallStreamingOperator",
                        lambda *a, **kw: built.append(kw) or "tall stream")
    _stub_card(monkeypatch, 1000)
    assert build_packed_operator(ds, data["mean"], data["sd"], tall=True,
                                 memory_mb=7) == "tall stream"
    assert built[0]["memory_mb"] == 7


def _cli(args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return tmain(args)
    finally:
        os.chdir(old)


def test_cli_stream_on_matches_stream_off(data, tmp_path, capsys):
    outs = {}
    for mode in ("on", "off"):
        d = tmp_path / mode
        d.mkdir()
        assert _cli(["--bfile", data["root"], "--ndim", "3", "--device",
                     "cpu", "--stream", mode, "--memory", "3", "--notime"],
                    d) == 0
        outs[mode] = (d / "eigenvalues.txt").read_text()
        assert _cli(["--bfile", data["root"], "--check", "--device", "cpu",
                     "--stream", mode, "--memory", "3", "--notime"], d) == 0
    assert outs["on"] == outs["off"]
    np.testing.assert_allclose(np.loadtxt(tmp_path / "on" / "pcs.txt",
                                          skiprows=1, usecols=(2, 3, 4)),
                               np.loadtxt(tmp_path / "off" / "pcs.txt",
                                          skiprows=1, usecols=(2, 3, 4)),
                               rtol=1e-6, atol=1e-9)
    err = capsys.readouterr().err
    assert "Exception" not in err and "Error" not in err


def test_cli_memory_sets_the_reference_block_size(tmp_path, monkeypatch,
                                                  capsys):
    """``--stream on --memory M`` stages blocks of the reference's
    ``--memory`` block size (flashpca.cpp:636-684, as the JAX CLI), not
    of the library's ``(memory_mb << 20) // (2 * nbytes)``: the CLI turns
    ``--memory`` into ``block_size``, which takes precedence."""
    from flashpca_tpu_torch.cli import _block_size_from_memory
    from flashpca_tpu_torch.ops import operator as top

    rng = np.random.default_rng(5)
    n, p = 1000, 300
    root = str(tmp_path / "m")
    write_bed(root, _geno(rng, n, p))
    built = []

    class Recording(top.StreamingPackedOperator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(top, "StreamingPackedOperator", Recording)
    assert _cli(["--bfile", root, "--ndim", "3", "--device", "cpu",
                 "--opmode", "wide", "--stream", "on", "--memory", "3",
                 "--notime"],
                tmp_path) == 0
    want = _block_size_from_memory(3, n, p, 3, False, False)
    assert want == 116 < p < (3 << 20) // (2 * (n + 3) // 4)
    assert [(op.block_snps, op.n_blocks) for op in built] == [(want, 3)]
    assert f"blocksize: {want}" in capsys.readouterr().out


def test_streaming_state_out_resumes_resident(data, tmp_path):
    """A streaming run's checkpoint resumes on the resident operator (the
    JAX package's test_checkpoint.py streaming composition)."""
    root = data["root"]
    state = str(tmp_path / "ritz.npz")
    with pytest.raises(RuntimeError, match="not successful"):
        ft.pca(root, 3, tol=1e-12, maxiter=1, streaming=True, memory_mb=1,
               state_out=state, device="cpu")
    warm = ft.pca(root, 3, tol=1e-9, state_in=state, device="cpu")
    ref = ft.pca(root, 3, tol=1e-9, device="cpu")
    np.testing.assert_allclose(warm.values, ref.values, rtol=1e-7)
    for j in range(3):
        assert abs(np.dot(warm.vectors[:, j], ref.vectors[:, j])) > 1 - 1e-7


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_same_order_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's streamed same-order phase, rehearsed at tiny sizes
    with the kernels' plain versions standing in for the kernels (no
    launches to count here): every configuration's products bit-equal
    to their same-order references and its staging counts right."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    cases = (("aligned", 96, 250, 24, {"block_snps": 11}),
             ("odd", 50, 101, 25, {"block_snps": 7}))
    out = cs.check_streamed(torch.device("cpu"), cases, dtype=torch.float32,
                            use_kernels=True)
    assert len(out) == len(cases) * len(cs.STREAM_CONFIGS)
    assert out["aligned/1/3"]["staged_host_blocks"] == 9 + 11 * 6


def test_smoke_twin_cosines_hold_a_cluster_by_its_span():
    """chip_smoke.twin_cosines: a pair rotated within its span loses
    |cos| with its twins, while the span's principal angle stays 0; a
    pair farther apart than ``near`` is held by |cos| alone."""
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((50, 5)))
    d = np.array([10.0, 9.0, 5.0, 4.99999, 1.0])
    c, s = np.cos(0.01), np.sin(0.01)
    U = Q.copy()
    U[:, 2] = c * Q[:, 2] + s * Q[:, 3]
    U[:, 3] = -s * Q[:, 2] + c * Q[:, 3]
    cos, held, clusters = cs.twin_cosines(U * 3.0, Q, d, near=1e-3)
    assert clusters == [[2, 3]]
    np.testing.assert_allclose(cos, [1, 1, c, c, 1], rtol=1e-12)
    np.testing.assert_allclose(held, 1.0, rtol=1e-12)
    cos, held, clusters = cs.twin_cosines(U, Q, d, near=1e-6)
    assert clusters == [] and np.array_equal(cos, held)
