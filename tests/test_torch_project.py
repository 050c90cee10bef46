"""The port's ``project()`` and ``--project`` against the JAX package's.

Fileset: 203 samples (n % 4 == 3, so every SNP's last byte carries one
garbage sample position) x 150 SNPs, 3% missing calls and one constant
SNP (inv_sd == 0); the loadings are seeded normal draws.  The same
loadings and stats go through ``flashpca_tpu.models.project`` and the
port.

Tolerances:

* float64: rtol 1e-10 elementwise (the same float64 math in another
  summation order);
* float32 (the functional core, and the kernel wrappers' plain versions
  with ``use_kernels=True``): rtol 1e-5 with atol 1e-5 x the largest
  |entry| (float32 accumulation over 150 SNPs, near-cancelling entries
  held by the atol), against the JAX package at float32;
* streamed against resident: rtol 1e-12;
* the CLI: byte for byte (the golden file, and the JAX CLI's output).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
from flashpca_tpu.cli import main as jmain
from flashpca_tpu.io.plink import write_bed
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.models.project import _project_operator
from flashpca_tpu_torch.ops.operator import packed_operator_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
K = 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(31)
    n, p = 203, 150
    freq = rng.uniform(0.05, 0.5, p)
    geno = rng.binomial(2, freq[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.03] = np.nan
    geno[:, 11] = 1.0                                   # a constant SNP
    root = str(tmp_path_factory.mktemp("proj") / "d")
    write_bed(root, geno)
    ds = ft.PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    V = rng.standard_normal((p, K))
    maf = np.clip(rng.uniform(0.02, 0.5, p), 0.0, 0.5)
    return dict(root=root, n=n, p=p, V=V, mean=mean, sd=sd, maf=maf,
                geno=geno, ds=ds)


def _stats_kw(data, which):
    return {"data": {},
            "meansd": {"meansd": np.column_stack([data["mean"],
                                                  data["sd"]])},
            "maf": {"maf": data["maf"]},
            "orig": {"orig_mean": data["mean"] + 0.01,
                     "orig_sd": data["sd"] * 1.1}}[which]


@pytest.mark.parametrize("divisor", ["p", "n1", "none"])
@pytest.mark.parametrize("which", ["data", "meansd", "maf", "orig"])
def test_project_float64_matches_jax(data, which, divisor):
    kw = _stats_kw(data, which)
    want = fj.project(data["root"], data["V"], divisor=divisor,
                      dtype=jnp.float64, **kw).projection
    got = ft.project(data["root"], data["V"], divisor=divisor,
                     device="cpu", **kw).projection
    assert got.shape == (data["n"], K) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("which", ["meansd", "maf"])
def test_project_float32_matches_jax(data, which):
    """float32 through the functional core (``project``) and through the
    kernel wrappers' plain versions (``_project_operator`` on a
    ``use_kernels=True`` operator), against the JAX package at float32
    (its jnp path on the CPU)."""
    kw = _stats_kw(data, which)
    want = fj.project(data["root"], data["V"], dtype=jnp.float32,
                      **kw).projection
    atol = 1e-5 * np.abs(want).max()
    got = ft.project(data["root"], data["V"], device="cpu",
                     dtype=torch.float32, **kw).projection
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    if which == "maf":
        ms = ft.io.text.maf2meansd(data["maf"])
        mean, sd = ms[:, 0], ms[:, 1]
    else:
        mean, sd = data["mean"], data["sd"]
    op = packed_operator_from_numpy(data["ds"].read_packed(), mean, sd,
                                    data["n"], device="cpu",
                                    dtype=torch.float32, use_kernels=True)
    tpk.reset_launch_counts()
    got_k = _project_operator(op, data["V"], data["p"])
    np.testing.assert_allclose(got_k, want, rtol=1e-5, atol=atol)
    # tensors on the CPU take the plain versions: no kernel launched
    assert set(tpk.launch_counts.values()) == {0}
    assert op.nops == 1                                  # one prod pass


def test_project_maf_keeps_the_variance_quirk(data):
    """--inmaf's sd slot holds the binom2 VARIANCE 2 maf (1 - maf), not
    its square root (randompca.cpp:745-751), as in the JAX package."""
    maf = data["maf"]
    ms = np.column_stack([2 * maf, 2 * maf * (1 - maf)])
    a = ft.project(data["root"], data["V"], maf=maf, device="cpu")
    b = ft.project(data["root"], data["V"], meansd=ms, device="cpu")
    np.testing.assert_array_equal(a.projection, b.projection)


@pytest.mark.parametrize("stream_kw", [dict(block_size=17),
                                       dict(memory_mb=1)],
                         ids=["block_size", "memory_mb"])
def test_project_streamed_matches_resident(data, stream_kw):
    res = ft.project(data["root"], data["V"], device="cpu").projection
    got = ft.project(data["root"], data["V"], device="cpu", streaming=True,
                     **stream_kw).projection
    np.testing.assert_allclose(got, res, rtol=1e-12)
    want = fj.project(data["root"], data["V"], dtype=jnp.float64,
                      streaming=True, **stream_kw).projection
    np.testing.assert_allclose(got, want, rtol=1e-10)


def _raises_like_jax(call):
    """Both packages raise ValueError with the same message."""
    with pytest.raises(ValueError) as ej:
        call(fj.project, {"dtype": jnp.float64})
    with pytest.raises(ValueError) as et:
        call(ft.project, {"device": "cpu"})
    assert str(et.value) == str(ej.value)
    return str(et.value)


@pytest.mark.parametrize("case", [
    "loadings_rows", "ref_alleles_len", "ref_alleles_mismatch", "snp_ids",
    "meansd_and_maf", "orig_mean_alone", "orig_and_meansd", "maf_shape",
    "meansd_shape", "orig_shape", "divisor", "numeric_columns",
    "numeric_no_orig"])
def test_project_errors_match_jax(data, case):
    root, V, n, p = data["root"], data["V"], data["n"], data["p"]
    ds = data["ds"]
    ms = np.column_stack([data["mean"], data["sd"]])
    refs = list(ds.ref_alleles)
    bad_refs = refs.copy()
    bad_refs[7] = "Z"
    X = np.nan_to_num(data["geno"])
    calls = {
        "loadings_rows": lambda f, kw: f(root, V[:-1], **kw),
        "ref_alleles_len": lambda f, kw: f(root, V, ref_alleles=refs[:-1],
                                           **kw),
        "ref_alleles_mismatch": lambda f, kw: f(root, V,
                                                ref_alleles=bad_refs, **kw),
        "snp_ids": lambda f, kw: f(root, V, snp_ids=list(ds.snp_ids)[::-1],
                                   **kw),
        "meansd_and_maf": lambda f, kw: f(root, V, meansd=ms,
                                          maf=data["maf"], **kw),
        "orig_mean_alone": lambda f, kw: f(root, V,
                                           orig_mean=data["mean"], **kw),
        "orig_and_meansd": lambda f, kw: f(root, V, meansd=ms,
                                           orig_mean=data["mean"],
                                           orig_sd=data["sd"], **kw),
        "maf_shape": lambda f, kw: f(root, V, maf=data["maf"][:-1], **kw),
        "meansd_shape": lambda f, kw: f(root, V, meansd=ms[:, :1], **kw),
        "orig_shape": lambda f, kw: f(root, V, orig_mean=data["mean"][:-1],
                                      orig_sd=data["sd"][:-1], **kw),
        "divisor": lambda f, kw: f(root, V, divisor="q", **kw),
        "numeric_columns": lambda f, kw: f(X[:, :-1], V,
                                           orig_mean=data["mean"],
                                           orig_sd=data["sd"], **kw),
        "numeric_no_orig": lambda f, kw: f(X, V, **kw),
    }
    msg = _raises_like_jax(calls[case])
    assert msg


def test_project_refuses_a_mesh_naming_its_item(data):
    """``mesh=`` runs (ROADMAP A18 is ported): the 3-shard projection is
    the unsharded one at float64 (1e-12)."""
    from flashpca_tpu_torch.parallel import snp_mesh

    got = ft.project(data["root"], data["V"], mesh=snp_mesh(["cpu"] * 3))
    want = ft.project(data["root"], data["V"], device="cpu")
    np.testing.assert_allclose(got.projection, want.projection,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("divisor", ["p", "n1", "none"])
def test_project_numeric_matrix_matches_jax(data, divisor):
    """The numeric-matrix path (numpy float64): NaN entries become 0 after
    scaling, and an sd at 0 zeroes its column, as in the JAX package."""
    X = data["geno"]
    sd = data["sd"].copy()
    sd[3] = 0.0
    kw = dict(orig_mean=data["mean"], orig_sd=sd, divisor=divisor)
    got = ft.project(X, data["V"], **kw).projection
    want = fj.project(X, data["V"], **kw).projection
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _run_cli(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


def test_cli_project_reproduces_golden(small_plink, tmp_path):
    root, _ = small_plink
    rc = _run_cli(tmain, ["--bfile", root, "--project",
                          "--inload", os.path.join(GOLDEN, "pca",
                                                   "loadings.txt"),
                          "--inmeansd", os.path.join(GOLDEN, "pca",
                                                     "meansd.txt"),
                          "--ndim", "3", "--device", "cpu"], tmp_path)
    assert rc == 0
    with open(os.path.join(GOLDEN, "project", "projection.txt"), "rb") as fh:
        assert (tmp_path / "projection.txt").read_bytes() == fh.read()


def _write_frq(path, ds, maf):
    with open(path, "w") as fh:
        fh.write(" CHR SNP A1 A2 MAF NCHROBS\n")
        for sid, m in zip(ds.snp_ids, maf):
            fh.write(f"1 {sid} A C {m:.6g} 400\n")


def test_cli_project_inmaf_outproj_outmeansd_match_jax(data, tmp_path):
    """--inmaf (a .frq file), --outproj and --outmeansd after a
    projection (the MAF-derived stats, the variance quirk included):
    the port's files byte for byte the JAX CLI's."""
    ds = data["ds"]
    load = tmp_path / "load.txt"
    with open(load, "w") as fh:
        fh.write("SNP\tRefAllele\t" + "\t".join(f"V{i + 1}" for i in
                                               range(K)) + "\n")
        for sid, a, row in zip(ds.snp_ids, ds.ref_alleles, data["V"]):
            fh.write(f"{sid}\t{a}\t" + "\t".join(f"{v:.10g}" for v in row)
                     + "\n")
    frq = str(tmp_path / "d.frq")
    _write_frq(frq, ds, data["maf"])
    args = ["--bfile", data["root"], "--project", "--inload", str(load),
            "--inmaf", frq, "--outproj", "proj.txt", "--outmeansd",
            "ms.txt", "--notime"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run_cli(jmain, args, tmp_path / "jax") == 0
    assert _run_cli(tmain, args + ["--device", "cpu"], tmp_path / "port") == 0
    for fn in ("proj.txt", "ms.txt"):
        assert ((tmp_path / "port" / fn).read_bytes()
                == (tmp_path / "jax" / fn).read_bytes()), fn
    assert not (tmp_path / "port" / "projection.txt").exists()


@pytest.mark.parametrize("flags, message", [
    ([], "SNP-loadings must be specified using --inload"),
    (["--inload", "l.txt"], "one of MAF or mean/stdev must be specified"),
    (["--inload", "l.txt", "--inmaf", "a.frq", "--inmeansd", "m.txt"],
     "conflicting options requested --inmeansd, --inmaf"),
], ids=["no-inload", "no-stats", "both-stats"])
def test_cli_project_checks_match_jax(small_plink, tmp_path, capsys, flags,
                                      message):
    root, _ = small_plink
    args = ["--bfile", root, "--project"] + flags
    assert _run_cli(jmain, args, tmp_path) == 1
    jerr = capsys.readouterr().err
    assert _run_cli(tmain, args + ["--device", "cpu"], tmp_path) == 1
    terr = capsys.readouterr().err
    assert message in terr and message in jerr
    assert not (tmp_path / "projection.txt").exists()


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_mid_size_phases_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's mid-size phase at a tiny size on the CPU: the
    resident and streamed runs, then its float64 part (wide, tall and
    streamed pca, check at float64, held to dense eigh, no launch) and
    its CLI part (pca, --project and --ucca held to numpy float64
    oracles) -- with the CPU's float64 standing in for the card's
    float32 runs and no launches to require."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    out = cs.mid_size(torch.device("cpu"), str(tmp_path), n=1201, p=512,
                      k=5)
    f64 = out["float64"]
    assert f64["launches"] == 0 and f64["check_mse"] < 1e-8
    assert f64["wide"]["eig_err_of_largest"] < cs.F64_EIG_BAR
    assert f64["streamed"]["eig_rel_err_vs_resident"] <= 1e-12
    assert out["cli"]["project_col_rel_err"] < cs.PROJECT_BAR
    assert (tmp_path / "cli" / "ucca.txt").exists()


def test_smoke_project_ucca_phase_on_the_cpu(monkeypatch):
    """chip_smoke.project_ucca at a tiny size on the CPU, a float32
    operator with ``use_kernels=True`` (the kernels' plain versions) in
    place of the card's and stronger effects (UCCA_BETA 0.2, so the
    causal SNPs reach P < 1e-8 at n = 2,003): the self-projection, the
    float64 product and the ucca oracle hold (the projection at 1e-5:
    this size's population PCs have d ~ 20, not the headline's ~2e3, so
    the float32 decode constants' ~1e-6 offsets reach ~1e-6 of their
    columns, see chip_smoke.PROJECT_BAR)."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    monkeypatch.setattr(cs, "UCCA_BETA", 0.2)
    monkeypatch.setattr(cs, "PROJECT_BAR", 1e-5)
    n, p = 2003, 700
    packed, mean, sd, sumsq = cs.card_data(torch.device("cpu"), n, p, 7)
    op = ft.PackedOperator(packed, mean, sd, n, device="cpu",
                           dtype=torch.float32, use_kernels=True,
                           snp_sumsq=sumsq)
    res = ft.pca(op, 10)
    twins, out = cs.project_ucca(op, res)
    assert out["project"]["col_rel_err"] < 1e-5
    assert out["project"]["pop_min_abs_cos"] >= 1 - 1e-6
    assert len(out["ucca"]["causal"]) == cs.UCCA_K
    assert max(out["ucca"]["causal_p"]) < 1e-8
    assert twins["Px"].shape == (n, 10) and twins["Y"].shape == (n, 7)
    assert twins["ucca"].shape == (p, 3)


def test_smoke_streamed_twins_on_the_cpu(monkeypatch):
    """chip_smoke.streamed_headline at a tiny size on the CPU with the
    resident headline's project/ucca twins: the streamed ucca equals the
    resident one bit for bit (the kernels' plain versions here: B1's
    rows do not depend on the blocking) and the streamed projection
    holds to the resident one; the operators built at float32 with
    ``use_kernels=True``, the card's timers and memory counters stubbed,
    and the resident projection held at 1e-5 as in
    :func:`test_smoke_project_ucca_phase_on_the_cpu`."""
    import functools

    cs = _chip_smoke()
    for name in ("sync",):
        monkeypatch.setattr(cs, name, lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    monkeypatch.setattr(cs, "event_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(cs, "UCCA_BETA", 0.2)
    monkeypatch.setattr(cs, "PROJECT_BAR", 1e-5)
    monkeypatch.setattr(
        cs, "time_kernels",
        lambda op, widths, launches, worst, slices: [
            {"name": nm, "k": k, "launches": launches[nm]}
            for nm, k in widths])
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    for name in ("PackedOperator", "StreamingPackedOperator"):
        monkeypatch.setattr(ft, name, functools.partial(
            getattr(ft.ops.operator, name), dtype=torch.float32,
            use_kernels=True))
    cpu = torch.device("cpu")
    n, p, k = 4003, 700, 10             # two blocks of up to 523 SNPs
    packed, mean, sd, sumsq = cs.card_data(cpu, n, p, 7)
    op = ft.PackedOperator(packed, mean, sd, n, device=cpu, snp_sumsq=sumsq)
    res = ft.pca(op, k)
    threads = torch.get_num_threads()
    # one thread: the CPU's BLAS splits a product's sums by thread, so
    # its rows would depend on the block's rows (B1's do not)
    torch.set_num_threads(1)
    try:
        twins, _ = cs.project_ucca(op, res)
        rows, out = cs.streamed_headline(cpu, op.packed.numpy(), op.center,
                                         op.scale, sumsq, res, {},
                                         twins=twins, memory_mb=1)
    finally:
        torch.set_num_threads(threads)
    assert out["n_blocks"] == 2
    assert out["ucca"]["equal_to_resident"]
    assert out["project"]["col_rel_err_vs_resident"] < 1e-6
    assert [(r["name"], r["k"], r.get("path")) for r in rows][-2:] == [
        ("matvec", 24, "project_streaming"), ("crossprod", 8,
                                              "ucca_streaming")]
