"""The port's ``split_scca`` against the JAX package's, and
chip_smoke.py's two penalty-selection phases rehearsed on the CPU.

Inputs (numpy, seeded): the suite's ``small_plink``; PLINK filesets of
60-63 samples (every n % 4) x 37 SNPs with 5% missing calls and a
constant SNP; a 60 x 40 fileset on whose grid the JAX package's solo
host loop zeroes u at dimension 0 after a step.

Tolerances:

* float64 (the CPU path against the JAX package at x64): train and
  test correlations atol 1e-9; ``train_idx``, ``test_idx``, non-zero
  counts, converged flags and the best penalties equal;
* float32 (operators with ``use_kernels=True``, B1's and B2's plain
  versions, against the JAX package's float64 run): correlations atol
  1e-4, the U/V bar of tests/test_torch_scca.py's float32 case; flags,
  non-zero counts and best penalties equal;
* streamed against resident at float64: atol 1e-9.
"""

import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.models.scca_split import split_scca as jsplit
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.kernels import packed_matvec as tpk

from test_torch_cv_scca import _abort_case, float32_kernel_operators

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    out = {}
    base = tmp_path_factory.mktemp("split")
    for n in (60, 61, 62, 63):
        rng = np.random.default_rng(300 + n)
        p = 37
        maf = rng.uniform(0.05, 0.5, size=p)
        geno = rng.binomial(2, maf[None, :], size=(n, p)).astype(np.float64)
        geno[rng.uniform(size=geno.shape) < 0.05] = np.nan
        geno[:, 5] = 0.0
        root = str(base / f"g{n}")
        write_bed(root, geno)
        Y = rng.normal(size=(n, 3))
        Y[:, 0] += 0.7 * np.nan_to_num(geno[:, :4]).sum(axis=1)
        out[n % 4] = (root, geno, Y)
    return out


def same_split(got, want, corr_atol=1e-9):
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.nzero_x, want.nzero_x)
    np.testing.assert_array_equal(got.nzero_y, want.nzero_y)
    for key in ("corr_train", "corr_test"):
        a, b = getattr(got, key), getattr(want, key)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=corr_atol,
                                   err_msg=key)
    assert (got.best_lambda1, got.best_lambda2) == (want.best_lambda1,
                                                    want.best_lambda2)
    assert abs(got.best_corr - want.best_corr) <= corr_atol


@pytest.mark.parametrize("engine", ["auto", "host"])
@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
def test_split_scca_matches_jax(filesets, tmp_path, nmod, engine):
    """The grid path (one scca_grid, both projections one product each)
    and the sequential fallback on every n % 4; the train and test
    filesets the JAX package's byte for byte."""
    root, _, Y = filesets[nmod]
    kw = dict(lambda1=[1e-3, 5e-2], lambda2=[1e-4, 1e-2], ndim=2,
              prop_train=0.7, seed=3 + nmod, maxiter=600, tol=1e-8,
              engine=engine)
    got = ft.split_scca(root, Y, workdir=str(tmp_path / "t"), device="cpu",
                        **kw)
    want = jsplit(root, Y, workdir=str(tmp_path / "j"), **kw)
    same_split(got, want)
    assert got.converged.all()
    for f in sorted(os.listdir(tmp_path / "j")):
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f


def test_split_scca_pipeline_recovers_signal(small_plink, tmp_path):
    """The JAX test's pipeline (scca.sh's split, grid, test projection
    with train statistics): the best test correlation clearly positive,
    in the port as in the JAX package."""
    root, geno = small_plink
    rng = np.random.default_rng(7)
    n = geno.shape[0]
    Y = rng.normal(size=(n, 3))
    Y[:, 0] += 0.8 * np.nan_to_num(geno[:, :4]).sum(axis=1)
    kw = dict(lambda1=[1e-3, 5e-2], lambda2=[1e-4], ndim=2, prop_train=0.7,
              seed=3, maxiter=500, tol=1e-6)
    got = ft.split_scca(root, Y, workdir=str(tmp_path / "t"), device="cpu",
                        **kw)
    assert got.corr_test.shape == (2, 2, 1) and got.converged.all()
    assert len(got.train_idx) + len(got.test_idx) == n
    assert got.best_corr > 0.3
    same_split(got, jsplit(root, Y, workdir=str(tmp_path / "j"), **kw))


def test_split_scca_missing_test_phenotypes(filesets, tmp_path):
    """A missing test phenotype is set to the training mean (0 after the
    training standardization), as in the JAX package."""
    root, _, Y = filesets[2]
    Y = Y.copy()
    Y[::7, 1] = np.nan
    kw = dict(lambda1=[1e-3], lambda2=[1e-4, 1e-2], ndim=2, seed=4,
              maxiter=600, tol=1e-8)
    got = ft.split_scca(root, Y, device="cpu", **kw)
    assert np.isfinite(got.corr_test).all()
    same_split(got, jsplit(root, Y, **kw))


def test_split_scca_streamed_matches_resident_and_jax(filesets):
    root, _, Y = filesets[3]
    kw = dict(lambda1=[1e-3, 2e-2], lambda2=[1e-4], ndim=2, prop_train=0.7,
              seed=3, maxiter=600, tol=1e-8)
    rr = ft.split_scca(root, Y, device="cpu", **kw)
    rs = ft.split_scca(root, Y, device="cpu", streaming=True, memory_mb=1,
                       **kw)
    same_split(rs, rr)
    same_split(rs, jsplit(root, Y, streaming=True, memory_mb=1, **kw))


def test_split_scca_workdirs(filesets, monkeypatch, tmp_path):
    """The default workdir is removed on success; a named one keeps the
    train and test filesets."""
    root, _, Y = filesets[0]
    made = []
    real = tempfile.mkdtemp

    def spy(*a, **k):
        k.setdefault("dir", str(tmp_path))
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    kw = dict(lambda1=[1e-3], lambda2=[1e-4], ndim=1, seed=2, tol=1e-8,
              device="cpu")
    ft.split_scca(root, Y, **kw)
    assert len(made) == 1 and not os.path.exists(made[0])
    wd = str(tmp_path / "kept")
    ft.split_scca(root, Y, workdir=wd, **kw)
    assert sorted(os.listdir(wd)) == sorted(
        f"g60_{s}{e}" for s in ("train", "test")
        for e in (".bed", ".bim", ".fam"))


def test_split_scca_refusals(filesets, monkeypatch, tmp_path):
    """The JAX package's refusals and messages; a ``mesh=`` conflicting
    with ``device=`` raises and a missing GPU raises, both before any
    repack."""
    root, _, Y = filesets[1]
    args = (Y, [1e-3], [1e-4])
    kw = dict(ndim=1, device="cpu")
    for bad in ("state_out", "state_in"):
        with pytest.raises(ValueError, match="cannot be forwarded"):
            ft.split_scca(root, *args, **kw, **{bad: "s.npz"})
    with pytest.raises(ValueError, match="Y rows must match"):
        ft.split_scca(root, Y[:-1], [1e-3], [1e-4], **kw)
    for prop in (0.0, 1.0):
        with pytest.raises(ValueError, match="prop_train must be in"):
            ft.split_scca(root, *args, prop_train=prop, **kw)
    with pytest.raises(ValueError, match="degenerate train/test split"):
        ft.split_scca(root, *args, prop_train=1e-9, **kw)
    with pytest.raises(ValueError, match="opt_dim must be between"):
        ft.split_scca(root, *args, opt_dim=3, **kw)
    for extra in ({"streaming": True}, {"memory_mb": 8}):
        with pytest.raises(ValueError, match="needs a resident operator"):
            ft.split_scca(root, *args, engine="device", **kw, **extra)
    wd = str(tmp_path / "wd")
    from flashpca_tpu_torch.parallel import snp_mesh

    with pytest.raises(ValueError, match="conflicts with the mesh"):
        ft.split_scca(root, *args, mesh=snp_mesh(["cpu"] * 2), workdir=wd,
                      **dict(kw, device="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.split_scca(root, *args, ndim=1, workdir=wd)
    assert not os.path.exists(wd)


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_split_scca_float32_through_kernel_wrappers(filesets, monkeypatch,
                                                    engine):
    root, _, Y = filesets[0]
    kw = dict(lambda1=[1e-3, 5e-2], lambda2=[1e-4, 1e-2], ndim=2,
              prop_train=0.7, seed=6, maxiter=2000, tol=1e-5, engine=engine)
    want = jsplit(root, Y, **kw)
    calls = float32_kernel_operators(monkeypatch)
    tpk.reset_launch_counts()
    got = ft.split_scca(root, Y, device="cpu", dtype=torch.float32, **kw)
    assert set(tpk.launch_counts.values()) == {0}
    assert calls["crossprod"] > 0 and calls["matvec"] > 0
    same_split(got, want, corr_atol=1e-4)


def test_split_scca_dim0_abort_matches_jax(tmp_path):
    """On the sequential fallback a dimension-0 abort after a step keeps
    the vector of the step before (the JAX package's solo host loop), so
    the non-zeros are the JAX package's; its grid path keeps the zeroed
    vector, which is how the case shows that such an abort happened."""
    X, Y, l1, l2 = _abort_case(seed=2)
    root = str(tmp_path / "abort")
    write_bed(root, X)
    kw = dict(ndim=2, seed=2, maxiter=200, tol=1e-6, prop_train=0.7)
    host = ft.split_scca(root, Y, l1, l2, engine="host", device="cpu", **kw)
    same_split(host, jsplit(root, Y, l1, l2, engine="host", **kw))
    grid = ft.split_scca(root, Y, l1, l2, device="cpu", **kw)
    same_split(grid, jsplit(root, Y, l1, l2, **kw))
    assert (host.nzero_x != grid.nzero_x).sum() >= 1


# ---------------------------------------------------------------------------
# chip_smoke.py's penalty-selection phases rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_cv_split_phases_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.mid_cv_split on a 601 x 300 fileset and
    headline_cv_split at 2,003 x 700 (probe 350 SNPs) on the CPU, the
    packed operators at float32 through the kernels' plain versions, no
    launches to require: every hold passes (float32 against float64,
    the grid against the sequential fallback, streamed against resident,
    the matrix path, the best split cell against its solo run and its
    float64 test correlation, the repacked rows, the scratch), the
    headline's D is the whole 700 SNPs, each path's rows are B1 and B2
    at kc 16 with its launch counts.  The planted directions on 2,003
    samples give a test correlation of ~0.73, so the floor is 0.5 here
    (0.8 at the headline's 501,760)."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "require_launched", lambda *a: None)
    monkeypatch.setattr(cs, "CV_PROBE_SNPS", 350)
    monkeypatch.setattr(cs, "CV_MIN_CORR", 0.5)
    widths = []

    def timed(op, w, launches, worst, slices):
        widths.append((op.n_samples, w))
        return [{"name": nm, "k": k, "launches": launches[nm]}
                for nm, k in w]

    monkeypatch.setattr(cs, "time_kernels", timed)
    float32_kernel_operators(monkeypatch)
    dev = torch.device("cpu")
    rng = np.random.default_rng(5)
    n, p = 601, 300
    geno = rng.binomial(2, rng.uniform(0.05, 0.5, p)[None, :],
                        size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / "mid")
    write_bed(root, geno)
    mid = cs.mid_cv_split(dev, root, ft.PlinkDataset.open(root), 5)
    assert len(mid["holds"]) == 6
    assert all(h["corr_abs"] <= cs.CV_CORR_BAR for h in mid["holds"].values())

    n, p = 2003, 700
    packed, mean, sd, _ = cs.card_data(dev, n, p, 7)
    rows, out = cs.headline_cv_split(dev, packed.numpy(), mean, sd, n)
    assert out["snps"] == 700 and out["samples"] == n
    sp, cv = out["split"], out["cv"]
    assert sp["rows_equal"] and sp["solo_converged"]
    assert abs(sp["corr_float64"] - sp["best"][2]) <= cs.CV_F64_CORR_BAR
    assert max(sp["solo_d_rel"]) <= cs.SCCA_GRID_D_BAR
    assert len(cv["grid_s"]) == len(cv["init_s"]) == cs.CV_FOLDS
    assert len(sp["repack_s"]) == 1 and len(cv["repack_s"]) == cs.CV_FOLDS
    assert [(r["path"], r["name"], r["k"]) for r in rows] == [
        ("split_scca", "crossprod", 16), ("split_scca", "matvec", 16),
        ("cv_scca", "crossprod", 16), ("cv_scca", "matvec", 16)]
    assert widths[0][0] == sp["train"] and widths[1][0] == n - cv["folds"][0]
