"""The port's ``ucca()`` and ``--ucca`` against the JAX package's.

Fileset: 203 samples (n % 4 == 3) x 150 SNPs, 3% missing calls and one
constant SNP, whose R is nan in both packages (the reference's 0/0);
Y is 3 phenotypes, two of them carrying effects of SNPs 20 and 60.

Tolerances:

* float64: rtol 1e-10 on R, F and P (the same float64 math in another
  summation order), nan where the JAX package has nan;
* float32 (a ``use_kernels=True`` operator, the kernel wrappers' plain
  versions, against the JAX operator at float32 on its jnp path): R and
  F at rtol 1e-5, -log10 P within 1e-4 absolute (P's relative error is
  F's times d ln P / d ln F, about 10 for the causal SNPs here);
* streamed against resident: rtol 1e-12 on the functional core, and
  bit for bit through the kernel wrappers (B1's rows do not depend on
  the blocking);
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
from flashpca_tpu.ops.operator import PackedOperator as JPackedOperator
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as tmain
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops import operator as top
from flashpca_tpu_torch.ops.operator import (packed_operator_from_numpy,
                                             streaming_operator_from_numpy)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(41)
    n, p = 203, 150
    freq = rng.uniform(0.05, 0.5, p)
    geno = rng.binomial(2, freq[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.03] = np.nan
    geno[:, 11] = 0.0                                   # a constant SNP
    root = str(tmp_path_factory.mktemp("ucca") / "d")
    write_bed(root, geno)
    g = np.nan_to_num(geno - np.nanmean(geno, axis=0))
    Y = rng.standard_normal((n, 3))
    Y[:, 0] += 0.8 * g[:, 20]
    Y[:, 2] += 0.6 * g[:, 60]
    ds = ft.PlinkDataset.open(root)
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    return dict(root=root, n=n, p=p, Y=Y, geno=geno, ds=ds, mean=mean,
                sd=sd, sumsq=sumsq)


def _same(got, want, rtol):
    """Equal nan positions, the rest within rtol."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)


@pytest.mark.parametrize("stand_y", ["sd", "center", "none"])
def test_ucca_float64_matches_jax(data, stand_y):
    want = fj.ucca(data["root"], data["Y"], stand_y=stand_y,
                   dtype=jnp.float64)
    got = ft.ucca(data["root"], data["Y"], stand_y=stand_y, device="cpu")
    assert got.result.shape == (data["p"], 3)
    assert (got.npheno, got.nsnps) == (want.npheno, want.nsnps) == (3, 150)
    _same(got.result, want.result, 1e-10)
    # the constant SNP: 0/0, as the reference
    assert np.isnan(got.r[11]) and np.isnan(want.r[11])
    # the causal SNPs stand out
    assert got.pval[20] < 1e-6 and got.pval[60] < 1e-4


def test_ucca_float32_through_kernel_wrappers_matches_jax(data):
    """A prebuilt float32 operator with ``use_kernels=True`` (B1's plain
    version on the CPU) against the JAX operator at float32."""
    ds = data["ds"]
    jop = JPackedOperator(ds.read_packed(), data["mean"], data["sd"],
                          data["n"], dtype=jnp.float32, use_pallas=False)
    want = fj.ucca(jop, data["Y"])
    op = packed_operator_from_numpy(ds.read_packed(), data["mean"],
                                    data["sd"], data["n"],
                                    snp_sumsq=data["sumsq"], device="cpu",
                                    dtype=torch.float32, use_kernels=True)
    tpk.reset_launch_counts()
    got = ft.ucca(op, data["Y"])
    assert set(tpk.launch_counts.values()) == {0}
    assert op.nops == 1                          # one crossprod pass
    _same(got.result[:, :2], want.result[:, :2], 1e-5)
    ok = ~np.isnan(want.pval)
    np.testing.assert_allclose(-np.log10(got.pval[ok]),
                               -np.log10(want.pval[ok]), atol=1e-4)


def test_ucca_streamed_matches_resident(data):
    Y = data["Y"]
    res = ft.ucca(data["root"], Y, device="cpu")
    for kw in (dict(block_size=13), dict(memory_mb=1)):
        got = ft.ucca(data["root"], Y, device="cpu", streaming=True, **kw)
        _same(got.result, res.result, 1e-12)
    want = fj.ucca(data["root"], Y, dtype=jnp.float64, streaming=True,
                   block_size=13)
    _same(ft.ucca(data["root"], Y, device="cpu", streaming=True,
                  block_size=13).result, want.result, 1e-10)
    # through the kernel wrappers: each SNP's row is the resident one
    ds = data["ds"]
    args = (ds.read_packed(), data["mean"], data["sd"], data["n"])
    kw = dict(snp_sumsq=data["sumsq"], device="cpu", dtype=torch.float32,
              use_kernels=True)
    resident = ft.ucca(packed_operator_from_numpy(*args, **kw), Y)
    streamed = ft.ucca(streaming_operator_from_numpy(*args, block_snps=13,
                                                     **kw), Y)
    assert np.array_equal(streamed.result, resident.result, equal_nan=True)


def test_ucca_numeric_matrix_matches_jax(data):
    X = data["geno"].copy()
    X[:, 11] = 1.0
    for stand_x in ("binom2", "sd"):
        want = fj.ucca(X, data["Y"], stand_x=stand_x)
        got = ft.ucca(X, data["Y"], stand_x=stand_x, device="cpu")
        _same(got.result, want.result, 1e-12)


def test_ucca_refuses_tall_operators(data):
    ds = data["ds"]
    args = (ds.read_packed(), data["mean"], data["sd"], data["n"])
    want = None
    try:
        fj.ucca(fj.TallPackedOperator(*args), data["Y"])
    except ValueError as e:
        want = str(e)
    for op in (top.tall_operator_from_numpy(*args, device="cpu"),
               top.tall_streaming_operator_from_numpy(*args, block_bytes=8,
                                                      device="cpu")):
        with pytest.raises(ValueError) as e:
            ft.ucca(op, data["Y"])
        assert str(e.value) == want


def test_ucca_errors(data):
    ds = data["ds"]
    Y, root = data["Y"], data["root"]
    op = packed_operator_from_numpy(ds.read_packed(), data["mean"],
                                    data["sd"], data["n"], device="cpu")
    rows = "Y rows must equal the number of samples"
    for call in (lambda f, kw: f(root, Y[:-1], **kw),
                 lambda f, kw: f(np.nan_to_num(data["geno"])[:-2], Y, **kw)):
        for f, kw in ((fj.ucca, {}), (ft.ucca, {"device": "cpu"})):
            with pytest.raises(ValueError, match=rows):
                call(f, kw)
    with pytest.raises(ValueError, match=rows):
        ft.ucca(op, Y[:-1])
    with pytest.raises(ValueError, match="stand_x= was passed with a "
                                         "prebuilt operator"):
        ft.ucca(op, Y, stand_x="binom2")
    for kw, what in ((dict(dtype=torch.float32), "dtype="),
                     (dict(memory_mb=8), "memory_mb="),
                     (dict(block_size=8), "block_size="),
                     (dict(streaming=True), "streaming=True")):
        with pytest.raises(ValueError, match=what):
            ft.ucca(op, Y, **kw)
    with pytest.raises(ValueError, match="unknown standardization"):
        ft.ucca(root, Y, stand_y="zz", device="cpu")
    # mesh= runs (A18): 3 CPU shards give the unsharded result, and a
    # prebuilt operator meets another mesh with the conflict error
    from flashpca_tpu_torch.parallel import snp_mesh

    np.testing.assert_allclose(
        ft.ucca(root, Y, mesh=snp_mesh(["cpu"] * 3)).result,
        ft.ucca(root, Y, device="cpu").result, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="mesh= conflicts"):
        ft.ucca(op, Y, mesh=snp_mesh(["cpu"] * 3))


def test_ucca_refuses_a_dense_operator_naming_a12(data):
    """The port's DenseOperator against the JAX one on the same matrix
    (R, F and P at rtol 1e-10, nan at the constant SNP in both); a JAX
    DenseOperator handed to the port is refused, not run."""
    X = np.nan_to_num(data["geno"])
    jdense = fj.DenseOperator(X, dtype=jnp.float64)
    want = fj.ucca(jdense, data["Y"]).result
    got = ft.ucca(ft.DenseOperator(X, device="cpu"), data["Y"]).result
    flat = np.isnan(want[:, 0])
    assert flat[11] and np.array_equal(np.isnan(got[:, 0]), flat)
    np.testing.assert_allclose(got[~flat], want[~flat], rtol=1e-10)
    with pytest.raises(TypeError, match="not an operator of this package"):
        ft.ucca(jdense, data["Y"])


def _run_cli(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


def _write_pheno(path, fam_root, Y):
    fam = np.loadtxt(fam_root + ".fam", dtype=str)
    with open(path, "w") as fh:
        for i in range(Y.shape[0]):
            fh.write(f"{fam[i, 0]}\t{fam[i, 1]}\t"
                     + "\t".join(f"{v:.10g}" for v in Y[i]) + "\n")


def test_cli_ucca_reproduces_golden(small_plink, tmp_path):
    """tests/golden/regen.py's ucca case: seed-7 phenotypes on the
    seed-42 toy fileset."""
    root, geno = small_plink
    Y = np.random.default_rng(7).standard_normal((geno.shape[0], 3))
    pheno = str(tmp_path / "pheno.txt")
    _write_pheno(pheno, root, Y)
    assert _run_cli(tmain, ["--bfile", root, "--ucca", "--pheno", pheno,
                            "--device", "cpu"], tmp_path) == 0
    with open(os.path.join(GOLDEN, "ucca", "ucca.txt"), "rb") as fh:
        assert (tmp_path / "ucca.txt").read_bytes() == fh.read()


@pytest.mark.parametrize("flags", [
    ["--standy", "center", "--suffix", ".tsv"],
    ["--standx", "binom", "--stream", "on", "--blocksize", "20",
     "--outmeansd", "ms.txt"],
], ids=["standy-suffix", "binom-streamed-outmeansd"])
def test_cli_ucca_matches_jax(data, tmp_path, flags):
    pheno = str(tmp_path / "pheno.txt")
    _write_pheno(pheno, data["root"], data["Y"])
    args = ["--bfile", data["root"], "--ucca", "--pheno", pheno,
            "--notime"] + flags
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run_cli(jmain, args, tmp_path / "jax") == 0
    assert _run_cli(tmain, args + ["--device", "cpu"], tmp_path / "port") == 0
    outs = sorted(os.listdir(tmp_path / "jax"))
    assert outs == sorted(os.listdir(tmp_path / "port"))
    for fn in outs:
        assert ((tmp_path / "port" / fn).read_bytes()
                == (tmp_path / "jax" / fn).read_bytes()), fn


def test_cli_ucca_checks(data, tmp_path, capsys):
    root = data["root"]
    assert _run_cli(tmain, ["--bfile", root, "--ucca", "--device", "cpu"],
                    tmp_path) == 1
    assert "you must specify a phenotype file" in capsys.readouterr().err
    short = str(tmp_path / "short.txt")
    _write_pheno(short, root, data["Y"])
    with open(short) as fh:
        lines = fh.readlines()
    with open(short, "w") as fh:
        fh.writelines(lines[:-1])
    assert _run_cli(tmain, ["--bfile", root, "--ucca", "--pheno", short,
                            "--device", "cpu"], tmp_path) == 1
    assert ("phenotype file rows must match .fam rows"
            in capsys.readouterr().err)
    # --ucca --batch runs the dense path: the JAX CLI's file
    pheno = str(tmp_path / "pheno.txt")
    _write_pheno(pheno, root, data["Y"])
    (tmp_path / "jax").mkdir()
    args = ["--bfile", root, "--ucca", "--batch", "--pheno", pheno]
    assert _run_cli(tmain, args + ["--device", "cpu"], tmp_path) == 0
    assert "ROADMAP" not in capsys.readouterr().err
    assert _run_cli(jmain, args, tmp_path / "jax") == 0
    assert ((tmp_path / "ucca.txt").read_bytes()
            == (tmp_path / "jax" / "ucca.txt").read_bytes())
    (tmp_path / "ucca.txt").unlink()
    # a stale --pheno on a PCA command line is not read
    assert _run_cli(tmain, ["--bfile", root, "--ndim", "2", "--pheno",
                            str(tmp_path / "missing.txt"), "--device",
                            "cpu"], tmp_path) == 0
