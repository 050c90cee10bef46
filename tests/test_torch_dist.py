"""The port's ``flashpca_tpu_torch.parallel`` against the JAX package's
``flashpca_tpu.parallel`` on the CPU: shard planning, per-shard loading
and the sharded operators, the counterpart of tests/test_dist.py.

The JAX package shards over its virtual 8-device CPU mesh
(tests/conftest.py); the port over a :class:`Mesh` of repeated ``"cpu"``
devices, which splits the work exactly as eight devices would.  Its
operators are built with ``use_pallas=False``, as the parity tests do.

Tolerances, with their reasons:

* float64 products and traces against the JAX package's sharded
  operator: rtol 1e-10 (the same sums in another order).
* the two-float gram, its pair summed in float64: rtol 1e-10 against
  the JAX package's float64 gram.
* ``pca`` across shard counts: eigenvalues rtol 1e-9, |cos| of the
  vectors > 1 - 1e-9 (tests/test_dist.py's bar: shard sums in another
  order amplified by the solver).
* float32 products through the kernels' plain versions on sharded
  operators against the float64 dense oracle: rtol/atol 2e-4 (the JAX
  package's interpret-mode bar, tests/test_mesh_modes.py); two-float
  pairs in float64 at 5e-6 relative (tests/test_compensated.py's bar).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import flashpca_tpu.parallel as jpar
from flashpca_tpu.io.plink import PlinkDataset as JDataset
from flashpca_tpu.ops import dense_standardized_np
from flashpca_tpu.ops.operator import PackedOperator as JPacked
import flashpca_tpu_torch as ft
import flashpca_tpu_torch.parallel as tpar
from flashpca_tpu_torch.parallel import (
    Mesh, load_sample_sharded_packed, load_sharded_packed, plan_byte_shards,
    plan_row_shards, sample_sharded_moments, shard_byte_ranges,
    sharded_operator, snp_mesh, tall_sharded_operator)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jmesh(n, axis="snps"):
    return JMesh(np.array(jax.devices("cpu")[:n]), (axis,))


def _cpu(n, axis="snps"):
    return snp_mesh(["cpu"] * n, axis_name=axis)


@pytest.fixture(scope="module")
def oracle(small_plink):
    root, _ = small_plink
    jds = JDataset.open(root)
    mean, sd = jds.snp_stats("binom2")
    X = dense_standardized_np(jds.read_codes(), mean, sd).T     # (N, p)
    rng = np.random.default_rng(2)
    return dict(root=root, ds=ft.PlinkDataset.open(root), X=X, mean=mean,
                sd=sd, x=rng.standard_normal((jds.n_samples, 3)),
                v=rng.standard_normal((jds.n_snps, 2)))


def test_parallel_exports_the_jax_package_names():
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert set(tpar.__all__) - set(jpar.__all__) == {"Mesh"}


def test_port_and_smoke_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (read from the sources, so a lazy import counts too)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flashpca_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "flashpca_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 30
    bad = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()):
                bad.append(os.path.relpath(f, REPO))
    assert not bad, bad


def test_byte_ranges_tile_file(oracle):
    ds = oracle["ds"]
    for nsh in (1, 4, 8):
        plan = ft.PackedOperator.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                                             nshards=nsh)
        assert plan["p_pad"] % nsh == 0 and plan["p_pad"] - ds.n_snps < nsh
        ranges = shard_byte_ranges(ds, plan["p_pad"], nsh)
        assert ranges[0][0] == 3                      # after the magic
        assert ranges[-1][1] == 3 + ds.n_snps * ds.nbytes_per_snp
        for (_, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c                             # contiguous
        # the JAX package's ranges on its own padded layout tile the
        # same bytes
        jplan = JPacked.plan_layout(
            ds.n_snps, ds.nbytes_per_snp, nshards=nsh, dtype=jnp.float64,
            use_pallas=False)
        jr = jpar.shard_byte_ranges(JDataset.open(oracle["root"]),
                                    jplan["p_pad"], nsh)
        assert (jr[0][0], jr[-1][1]) == (ranges[0][0], ranges[-1][1])


def test_plan_row_shards_even():
    rows = plan_row_shards(1024, 8)
    assert rows == jpar.plan_row_shards(1024, 8)
    assert rows[0] == (0, 128) and rows[-1] == (896, 1024)


def test_plan_byte_shards_even():
    assert plan_byte_shards(512, 4) == [(0, 128), (128, 256), (256, 384),
                                        (384, 512)]
    assert plan_byte_shards(512, 4) == jpar.plan_byte_shards(512, 4)


@pytest.mark.parametrize("nsh", [1, 2, 8])
def test_loaders_read_each_shard_s_bytes(oracle, nsh):
    """Each shard holds its rows (or byte columns) of the file and zeros
    in its padding; together they tile the bytes."""
    ds = oracle["ds"]
    packed = ds.read_packed()
    mesh = _cpu(nsh)
    plan = ft.PackedOperator.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                                         nshards=nsh)
    rows = torch.cat(load_sharded_packed(ds, mesh, p_pad=plan["p_pad"],
                                         nbytes_pad=plan["nbytes_pad"]))
    assert rows.shape == (plan["p_pad"], ds.nbytes_per_snp)
    np.testing.assert_array_equal(rows[: ds.n_snps].numpy(), packed)
    assert not rows[ds.n_snps:].any()
    tplan = ft.TallPackedOperator.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                                              nshards=nsh)
    cols = torch.cat(load_sample_sharded_packed(
        ds, mesh, p_pad=tplan["p_pad"], nbytes_pad=tplan["nbytes_pad"]),
        dim=1)
    assert cols.shape == (ds.n_snps, tplan["nbytes_pad"])
    assert tplan["nbytes_pad"] % (4 * nsh) == 0 or nsh == 1
    np.testing.assert_array_equal(cols[:, : ds.nbytes_per_snp].numpy(),
                                  packed)
    assert not cols[:, ds.nbytes_per_snp:].any()
    # one process: the moments are the file's
    for a, b in zip(sample_sharded_moments(ds, mesh,
                                           nbytes_pad=tplan["nbytes_pad"]),
                    ds.snp_moments()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nsh", [1, 2, 8])
def test_sharded_operator_matches_jax(oracle, nsh):
    """The port's sharded operator against the JAX package's on its
    nsh-device mesh: every product, the trace and the two-float gram."""
    op = sharded_operator(oracle["ds"], _cpu(nsh), dtype=torch.float64)
    jop = jpar.sharded_operator(JDataset.open(oracle["root"]), _jmesh(nsh),
                                dtype=jnp.float64, use_pallas=False)
    x, v = oracle["x"], oracle["v"]
    tol = dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(op.perform_op(x).numpy(),
                               np.asarray(jop.perform_op(x)), **tol)
    np.testing.assert_allclose(op.crossprod(x).numpy(),
                               np.asarray(jop.crossprod(x)), **tol)
    np.testing.assert_allclose(op.prod(v).numpy(),
                               np.asarray(jop.prod(v)), **tol)
    np.testing.assert_allclose(op.trace, jop.trace, rtol=1e-12)
    hi, lo = op.perform_op_ff(x)
    jhi, jlo = jop.perform_op_ff(jnp.asarray(x))
    np.testing.assert_allclose((hi + lo).numpy(),
                               np.asarray(jhi) + np.asarray(jlo), **tol)
    assert op.nshards == nsh and len(op._shards) == min(nsh, op.n_snps)


@pytest.mark.parametrize("nsh", [1, 2, 8])
def test_tall_sharded_operator_matches_jax(oracle, nsh):
    """Byte-column shards: the gram, prod and the analytic trace of the
    JAX package's sample-sharded operator (its 8-shard plan leaves four
    shards all padding, which the port skips)."""
    top = tall_sharded_operator(oracle["ds"], _cpu(nsh, "samples"),
                                dtype=torch.float64)
    jtop = jpar.tall_sharded_operator(JDataset.open(oracle["root"]),
                                      _jmesh(nsh, "samples"),
                                      dtype=jnp.float64, use_pallas=False)
    v = oracle["v"]
    tol = dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        top.gram_permuted(torch.as_tensor(v)).numpy(),
        np.asarray(jtop.gram_permuted(jtop.permute(jnp.asarray(v)))), **tol)
    np.testing.assert_allclose(top.prod(v).numpy(),
                               np.asarray(jtop.prod(v)), **tol)
    np.testing.assert_allclose(top.trace, jtop.trace, rtol=1e-12)
    top._sumsq = None                  # the device pass, summed in float64
    np.testing.assert_allclose(top.trace, jtop.trace, rtol=1e-12)


def test_end_to_end_sharded_pca(oracle):
    """pca() on a 4-shard operator equals the JAX package's local pca."""
    op = sharded_operator(oracle["ds"], _cpu(4), dtype=torch.float64)
    res = ft.pca(op, 3, tol=1e-9, do_loadings=True)
    from flashpca_tpu.models.pca import pca as jpca

    want = jpca(oracle["root"], 3, tol=1e-9, do_loadings=True)
    np.testing.assert_allclose(res.values, want.values, rtol=1e-9)
    for j in range(3):
        assert abs(np.dot(res.vectors[:, j], want.vectors[:, j])) > 1 - 1e-9
        assert abs(np.dot(res.loadings[:, j], want.loadings[:, j])
                   / np.linalg.norm(want.loadings[:, j]) ** 2) > 1 - 1e-9


def test_pca_shard_count_invariance(oracle):
    """pca() agrees across 1/2/4/8 shards, wide and tall (shard sums in
    another order: amplified round-off, not bit-equality)."""
    results = [ft.pca(oracle["root"], 2, tol=1e-10, maxiter=200,
                      mesh=_cpu(m)) for m in (1, 2, 4, 8)]
    results += [ft.pca(oracle["root"], 2, tol=1e-10, maxiter=200,
                       mesh=_cpu(m, "samples"), operator_mode="tall")
                for m in (2, 8)]
    d0, U0 = results[0].values, results[0].vectors
    for r in results[1:]:
        np.testing.assert_allclose(r.values, d0, rtol=1e-9)
        corr = np.abs(np.sum(r.vectors * U0, axis=0))
        assert np.all(corr > 1 - 1e-9), corr


def test_sharded_kernel_plain_versions_all_operators(oracle):
    """The four packed operators at float32 through the kernels' plain
    versions on a 4-shard mesh (the port of
    tests/test_mesh_modes.py::test_mesh_pallas_products_all_operators),
    two-float grams included."""
    ds, X, x, v = oracle["ds"], oracle["X"], oracle["x"][:, :2], oracle["v"]
    mean, sd = oracle["mean"], oracle["sd"]
    kw = dict(dtype=torch.float32, use_kernels=True)
    tol = dict(rtol=2e-4, atol=2e-4)
    gram = X @ (X.T @ x)

    def ff_close(pair, want):
        got = pair[0].double() + pair[1].double()
        assert float(np.linalg.norm(got.numpy() - want)
                     / np.linalg.norm(want)) < 5e-6

    for op in (ft.PackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                                 mesh=_cpu(4), **kw),
               ft.StreamingPackedOperator(ds, mean, sd, ds.n_samples,
                                          block_snps=16, mesh=_cpu(4), **kw)):
        np.testing.assert_allclose(op.perform_op(x).numpy(), gram, **tol)
        np.testing.assert_allclose(op.crossprod(x).numpy(), X.T @ x, **tol)
        np.testing.assert_allclose(op.prod(v).numpy(), X @ v, **tol)
        ff_close(op.perform_op_ff(x), gram)
        op._sumsq = None
        np.testing.assert_allclose(op.snp_sumsq, (X ** 2).sum(axis=0),
                                   rtol=1e-3)
    tgram = X.T @ (X @ v)
    for top in (ft.TallPackedOperator(ds.read_packed(), mean, sd,
                                      ds.n_samples, mesh=_cpu(4, "samples"),
                                      **kw),
                ft.TallStreamingOperator(ds, mean, sd, ds.n_samples,
                                         block_bytes=8,
                                         mesh=_cpu(2, "samples"), **kw)):
        vt = torch.as_tensor(v, dtype=torch.float32)
        np.testing.assert_allclose(top.gram_permuted(vt).numpy(), tgram,
                                   **tol)
        np.testing.assert_allclose(top.prod(v).numpy(), X @ v, **tol)
        ff_close(top.gram_ff_permuted(vt), tgram)


def test_mesh_layout_rules():
    """A device may repeat; the shards split in order; equal meshes
    compare equal; the loaders and builders refuse a 2-D mesh, as the
    JAX package's do."""
    m = _cpu(3)
    assert m.size == 3 and m.shape == {"snps": 3} and m.offset == 0
    assert m.local_shards == [(i, torch.device("cpu")) for i in range(3)]
    assert m == _cpu(3) and m != _cpu(2) and m != _cpu(3, "samples")
    assert not m.multiprocess and m.is_writer
    x = np.arange(4.0)
    assert m.agree(x) is x                   # one process: nothing to do
    flat = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("a", "b"))
    assert flat.size == 4 and flat.shape == {"a": 2, "b": 2}
    for fn in (sharded_operator, tall_sharded_operator):
        with pytest.raises(ValueError, match="1-D mesh"):
            fn("unused", flat)
    with pytest.raises(ValueError, match="2-D devices"):
        Mesh([["cpu"]], ("snps",))


def test_one_process_shards_are_views_of_the_bytes(oracle):
    """A mesh over a tensor already on its device holds row views of it
    (the card's two-shard headline costs no copy)."""
    ds = oracle["ds"]
    packed = torch.from_numpy(np.array(ds.read_packed()))
    op = ft.PackedOperator(packed, oracle["mean"], oracle["sd"],
                           ds.n_samples, mesh=_cpu(2))
    base = packed.data_ptr()
    for blk, lo, _ in op._shards:
        assert blk.data_ptr() == base + lo * ds.nbytes_per_snp


def test_init_distributed_is_idempotent(tmp_path):
    import torch.distributed as dist

    from flashpca_tpu_torch.parallel import init_distributed

    url = "file://" + str(tmp_path / "rendezvous")
    owned = not dist.is_initialized()
    try:
        init_distributed(backend="gloo", init_method=url, world_size=1,
                         rank=0)
        init_distributed(backend="gloo", init_method=url, world_size=1,
                         rank=0)
        assert dist.is_initialized()
        if owned:
            # one process in the group: the default mesh spans none
            assert dist.get_world_size() == 1
            assert not _cpu(2).multiprocess
    finally:
        if owned:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# chip_smoke.py's sharded phases rehearsed on the CPU, the card stubbed
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_card(cs, monkeypatch):
    """CPU shards for the card's, float32 operators through the kernels'
    plain versions (which count no launch, so none is required), and
    kernel rows recorded instead of timed."""
    import functools

    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    monkeypatch.setattr(cs, "card_mesh", lambda dev, shards, axis="snps":
                        _cpu(shards, axis))
    for name in ("PackedOperator", "TallPackedOperator"):
        monkeypatch.setattr(ft, name, functools.partial(
            getattr(ft, name), dtype=torch.float32, use_kernels=True))
    shapes = []

    def timed(op, widths, launches, worst, slices):
        shapes.append(tuple(op.packed.shape))
        return [{"name": nm, "k": k} for nm, k in widths]

    monkeypatch.setattr(cs, "time_kernels", timed)
    return shapes


def test_smoke_sharded_phases_on_the_cpu(monkeypatch):
    """chip_smoke.sharded_headline and sharded_tall at 2,003 x 700: the
    2-shard runs held to the one-shard ones (eigenvalues 1e-5, check mse
    < 1e-8), the shards row views of the wide bytes, the rows timed at
    one shard's shape."""
    cs = _chip_smoke()
    shapes = _stub_card(cs, monkeypatch)
    dev = torch.device("cpu")
    n, p, k = 2003, 700, 6
    packed, mean, sd, sumsq = cs.card_data(dev, n, p, 7)
    op = ft.PackedOperator(packed, mean, sd, n, device=dev, snp_sumsq=sumsq)
    res = ft.pca(op, k)
    chk = ft.check(op, res.vectors, res.values)
    rows, out = cs.sharded_headline(dev, op, res, {"check_mse": chk.mse,
                                                   "pca_s": 0.0}, None, k)
    assert out["eig_rel_err"] <= cs.SHARD_EIG_BAR and out["check_mse"] < 1e-8
    assert [(r["path"], r["name"], r["k"]) for r in rows] == [
        ("sharded", "crossprod", 16), ("sharded", "matvec", 16)]
    top = ft.TallPackedOperator(packed, mean, sd, n, device=dev,
                                snp_sumsq=sumsq)
    tres = ft.pca(top, k)
    tchk = ft.check(op, tres.vectors, tres.values)
    rows, out = cs.sharded_tall(dev, top, tres, {"check_mse": tchk.mse,
                                                 "pca_s": 0.0}, None, k)
    assert out["eig_rel_err"] <= cs.SHARD_EIG_BAR and out["check_mse"] < 1e-8
    assert [r["path"] for r in rows] == ["sharded_tall"] * 2
    nb = packed.shape[1]
    assert shapes == [(p // 2, nb), (p, -(-nb // 8) * 4)]


def test_smoke_mp_mesh_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.mp_mesh with its two ranks on gloo and CPU shards
    (``--mp-device cpu``) on a small structured fileset: every mode's
    ranks bit-equal and held to the one-process run."""
    from flashpca_tpu_torch.io.plink import write_bed

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    rng = np.random.default_rng(5)
    n, p, pops = 801, 400, 6
    pop = rng.choice(pops, size=n)
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.1, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / "mid")
    write_bed(root, geno)
    out = cs.mp_mesh(torch.device("cpu"), str(tmp_path), root)
    assert out["backend"] == "gloo" and out["cards"] == 0
    assert set(out) >= {"pca32", "pca64", "stream", "tall", "tallstream",
                        "scca", "collectives_ms"}
    assert out["pca64"]["rel_err"] <= cs.MP_F64_BAR


def test_shard_scaling_tool_on_the_cpu(monkeypatch):
    """tools/shard_scaling.py's run at 2,003 x 700 on 1 and 2 CPU shards:
    equal eigenvalues (float64, 1e-10) and the check contract."""
    import chip_smoke

    from flashpca_tpu_torch.tools import shard_scaling

    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    rows = shard_scaling.scaling(lambda s: ["cpu"] * s, [1, 2], 2003, 700,
                                 k=6)
    assert [r["shards"] for r in rows] == [1, 2]
    assert rows[1]["eig_rel_err"] < 1e-10
    assert all(r["check_mse"] < 1e-8 for r in rows)
    assert rows[0]["n_ops"] == rows[1]["n_ops"]


# ---------------------------------------------------------------------------
# The resident operator's three phases: the serial shard loop's results
# ---------------------------------------------------------------------------

PRODUCTS = ("gram", "cross", "prod", "ff", "sumsq")


def _serial(op, parts, product, x):
    """``product`` as one shard (or staged item) after another, each
    partial summed into the last in part order (``cross`` and ``sumsq``:
    the parts' rows laid end to end; ``ff``: the pairs folded by
    TwoSum), on the home device's constants: the loop the products ran
    before the resident operator's were split into phases."""
    from flashpca_tpu_torch.kernels import packed_matvec as kpm
    from flashpca_tpu_torch.ops import compensated, operator as opm

    def plain(name):
        if op.use_kernels:
            return getattr(kpm, name)
        core = getattr(opm, name)
        return lambda *a: core(*a, block_size=op.block_size)

    outs = []
    for blk, lo, hi in parts:
        m, iv = op.mean[lo:hi], op.invsd[lo:hi]
        if product == "gram":
            outs.append(plain("gram_matvec_p")(blk, m, iv, x))
        elif product == "cross":
            outs.append(plain("crossprod_p")(blk, m, iv, x))
        elif product == "prod":
            outs.append(plain("matvec_p")(blk, m, iv, x[lo:hi]))
        elif product == "sumsq":
            outs.append(opm.snp_sumsq_p(
                blk, m, iv, op._valid, block_size=opm.budget_block_size(
                    op._budget_rows(hi - lo), op.n4)))
        else:
            lh, ll = (t[lo:hi] for t in op._ff_luts())
            if op.use_kernels:
                outs.append(kpm.gram_ff_p(blk, lh, ll, x))
            else:
                bs = opm.budget_block_size(
                    op._budget_rows(hi - lo), op.n4, itemsize=8,
                    cap=compensated.default_chunk())
                outs.append(compensated.gram_ff_p(blk, lh, ll, x,
                                                  block_size=bs))
    if product in ("cross", "sumsq"):
        return torch.cat(outs)
    if product == "ff":
        hi, lo = outs[0]
        for t_hi, t_lo in outs[1:]:
            hi, e = compensated.twosum(hi, t_hi)
            lo = lo + e + t_lo
        return hi, lo
    acc = outs[0]
    for t in outs[1:]:
        acc = acc + t
    return acc


def _product(op, parts, product, x, v):
    """(the operator's public product, the serial loop's), with the
    products' own masks and permutations on both."""
    valid = op._valid[:, None]
    if product == "gram":
        return op.gram_permuted(x), _serial(op, parts, "gram", x * valid) * valid
    if product == "cross":
        xp = op.permute(x[: op.n_samples])
        return (op.crossprod(x[: op.n_samples]),
                _serial(op, parts, "cross", xp * valid))
    if product == "prod":
        want = _serial(op, parts, "prod", v) * valid
        return op.prod(v), op.unpermute(want)
    if product == "ff":
        hi, lo = _serial(op, parts, "ff", x * valid)
        return (torch.cat(op.gram_ff_permuted(x)),
                torch.cat((hi * valid, lo * valid)))
    op._sumsq = None
    return (torch.from_numpy(op.snp_sumsq),
            _serial(op, parts, "sumsq", None).to(torch.float64))


def _operands(op, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((op.n4, 3), generator=g, dtype=op.dtype),
            torch.randn((op.n_snps, 2), generator=g, dtype=op.dtype))


KINDS = {"kernels": dict(dtype=torch.float32, use_kernels=True),
         "core": dict(dtype=torch.float64)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("nsh", [4, 3])
@pytest.mark.parametrize("product", PRODUCTS)
def test_phased_shards_equal_the_serial_loop(oracle, product, nsh, kind):
    """On a one-process mesh of 4 CPU shards, and of 3 whose last is
    shorter, every wide product is the serial shard-order loop's bit for
    bit: the phases reorder the launches, not the sums."""
    ds = oracle["ds"]
    op = ft.PackedOperator(ds.read_packed(), oracle["mean"], oracle["sd"],
                           ds.n_samples, mesh=_cpu(nsh), **KINDS[kind])
    assert len({hi - lo for _, lo, hi in op._shards}) == 2
    got, want = _product(op, op._shards, product, *_operands(op))
    assert torch.equal(got, want)


@pytest.mark.parametrize("product", PRODUCTS)
def test_streaming_mesh_products_unchanged(oracle, product):
    """A StreamingPackedOperator on a 4-shard mesh still runs its staged
    items one after another: each product is that loop's bit for bit."""
    ds = oracle["ds"]
    op = ft.StreamingPackedOperator(ds, oracle["mean"], oracle["sd"],
                                    ds.n_samples, block_snps=16,
                                    mesh=_cpu(4), **KINDS["kernels"])
    assert op._cards is None
    items = [(torch.from_numpy(np.array(
        op._host_packed[lo:hi])), lo, hi) for lo, hi, _ in op._items]
    got, want = _product(op, items, product, *_operands(op))
    assert torch.equal(got, want)


def _xcard_count(op, product, x, v):
    """Bytes and copies of one product between shard 0's device and the
    others', counted by hand: each further shard's operand out and its
    partial home (a two-float pair is two)."""
    item = torch.tensor([], dtype=op.dtype).element_size()
    k = x.shape[1] if product != "prod" else v.shape[1]
    nbytes = copies = 0
    for _, lo, hi in op._shards[1:]:
        rows = hi - lo
        into, home, pieces = {"gram": (op.n4, op.n4, 1),
                              "cross": (op.n4, rows, 1),
                              "prod": (rows, op.n4, 1),
                              "ff": (op.n4, op.n4, 2)}[product]
        nbytes += (into + pieces * home) * k * item
        copies += 1 + pieces
    return nbytes, copies


@pytest.mark.parametrize("nsh", [1, 3, 4])
@pytest.mark.parametrize("product", ["gram", "cross", "prod", "ff"])
def test_xcard_counters_count_one_product(oracle, product, nsh):
    """``stats()``'s ``xcard_bytes``/``xcard_copies`` after one product
    are the hand count; 0 with one shard, and on an operator with no
    mesh."""
    ds = oracle["ds"]
    op = ft.PackedOperator(ds.read_packed(), oracle["mean"], oracle["sd"],
                           ds.n_samples, mesh=_cpu(nsh), **KINDS["kernels"])
    x, v = _operands(op)
    _product(op, op._shards, product, x, v)
    s = op.stats()
    assert (s["xcard_bytes"], s["xcard_copies"]) == _xcard_count(
        op, product, x, v)
    if nsh == 1:
        assert s["xcard_bytes"] == s["xcard_copies"] == 0
    plain = ft.PackedOperator(ds.read_packed(), oracle["mean"],
                              oracle["sd"], ds.n_samples, device="cpu",
                              **KINDS["kernels"])
    _product(plain, plain._shards, product, x, v)
    assert plain.stats()["xcard_bytes"] == plain.stats()["xcard_copies"] == 0


def _spans(tmp_path, fn):
    """The ``flashpca/`` spans of ``fn()`` under the profiler, as (start,
    end, name) sorted by start."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len("flashpca/"):]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("flashpca/"))


@pytest.mark.parametrize("nsh", [None, 4])
def test_mesh_spans_nest_in_the_product(oracle, tmp_path, nsh):
    """A sharded gram's ``mesh/scatter@k`` and ``mesh/gather@k`` lie inside
    its ``op/gram@k``, scatter first; an operator without a mesh has
    none."""
    ds = oracle["ds"]
    kw = dict(device="cpu") if nsh is None else dict(mesh=_cpu(nsh))
    op = ft.PackedOperator(ds.read_packed(), oracle["mean"], oracle["sd"],
                           ds.n_samples, **kw, **KINDS["kernels"])
    x, _ = _operands(op)
    spans = _spans(tmp_path, lambda: op.gram_permuted(x))
    names = [s[2] for s in spans]
    if nsh is None:
        assert names == ["op/gram@3"]
        return
    assert names == ["op/gram@3", "mesh/scatter@3", "mesh/gather@3"]
    outer = spans[0]
    assert all(outer[0] <= a and b <= outer[1] for a, b, _ in spans[1:])
    assert spans[1][1] <= spans[2][0]
