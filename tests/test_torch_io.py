"""Host IO of the PyTorch port against the JAX package: bit-identical
packed bytes, codes, moments, stats, standardization constants and
text output, on the small_plink fixture and on filesets with
n % 4 in {0, 1, 2, 3}."""

import importlib
import os

import numpy as np
import pytest

import flashpca_tpu.io.plink as jplink
import flashpca_tpu.io.text as jtext
import flashpca_tpu_torch.io.plink as tplink
import flashpca_tpu_torch.io.text as ttext

# (``ops`` re-exports a function named ``standardize``, which shadows the
# submodule of the same name as a package attribute)
jstd = importlib.import_module("flashpca_tpu.ops.standardize")
tstd = importlib.import_module("flashpca_tpu_torch.ops.standardize")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _compare_datasets(root):
    dj = jplink.PlinkDataset.open(root)
    dt = tplink.PlinkDataset.open(root)
    assert (dj.n_samples, dj.n_snps) == (dt.n_samples, dt.n_snps)
    assert dj.snp_ids == dt.snp_ids and dj.fam_ids == dt.fam_ids
    assert dj.ref_alleles == dt.ref_alleles and dj.bp == dt.bp
    _same(dj.read_packed(), dt.read_packed())
    _same(dj.read_codes(), dt.read_codes())
    _same(dj.read_codes(3, 7), dt.read_codes(3, 7))
    for a, b in zip(dj.snp_moments(), dt.snp_moments()):
        _same(a, b)
    for method in ("binom", "binom2"):
        for a, b in zip(dj.snp_stats(method, with_sumsq=True),
                        dt.snp_stats(method, with_sumsq=True)):
            _same(a, b)
        for a, b in zip(dj.snp_stats(method), dt.snp_stats(method)):
            _same(a, b)
    _same(dj.read_matrix(), dt.read_matrix())


def test_small_plink_bit_identical(small_plink):
    root, _ = small_plink
    _compare_datasets(root)


@pytest.mark.parametrize("n", [40, 41, 42, 43])
def test_write_bed_and_stats_bit_identical(tmp_path, n):
    rng = np.random.default_rng(100 + n)
    p = 13
    geno = rng.integers(0, 3, size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.1] = np.nan
    geno[:, 2] = 1.0                       # constant column
    geno[:, 4] = np.nan                    # all-missing column
    rj, rt = str(tmp_path / "j"), str(tmp_path / "t")
    jplink.write_bed(rj, geno)
    tplink.write_bed(rt, geno)
    for ext in (".bed", ".bim", ".fam"):
        with open(rj + ext, "rb") as a, open(rt + ext, "rb") as b:
            assert a.read() == b.read(), ext
    _compare_datasets(rt)
    codes = jplink.unpack_codes(jplink.PlinkDataset.open(rj).read_packed(), n)
    _same(jplink.pack_codes(codes, n), tplink.pack_codes(codes, n))
    _same(jplink.codes_to_dosage(codes), tplink.codes_to_dosage(codes))


def test_standardize_constants_bit_identical(rng):
    mean = rng.uniform(0.0, 2.0, 50)
    sd = rng.uniform(0.0, 1.0, 50)
    sd[:5] = 0.0
    sd[5] = tstd.VAR_TOL
    mean[6] = np.nan
    sd[6] = np.nan
    assert tstd.VAR_TOL == jstd.VAR_TOL
    for dt in (np.float32, np.float64):
        for a, b in zip(jstd.lookup_tables(mean, sd, dtype=dt),
                        tstd.lookup_tables(mean, sd, dtype=dt)):
            _same(a, b)
    ngood = rng.integers(1, 100, 50).astype(np.float64)
    dsum = rng.uniform(0, 2, 50) * ngood
    d2sum = dsum * 1.5
    _same(jstd.sumsq_from_moments(ngood, dsum, d2sum, mean, sd),
          tstd.sumsq_from_moments(ngood, dsum, d2sum, mean, sd))
    X = rng.integers(0, 3, (20, 6)).astype(np.float64)
    X[3, 2] = np.nan
    for method in ("none", "sd", "binom", "binom2", "center"):
        for a, b in zip(jstd.standardize(X, method),
                        tstd.standardize(X, method)):
            _same(a, b)


def test_text_writers_identical(tmp_path, rng):
    M = rng.standard_normal((5, 3)) * 10.0 ** rng.integers(-8, 8, (5, 3))
    kw = dict(colnames=["FID\tIID", "A", "B", "C"],
              rownames=[f"r{i}\tr{i}" for i in range(5)])
    jtext.save_text(M, str(tmp_path / "j.txt"), **kw)
    ttext.save_text(M, str(tmp_path / "t.txt"), **kw)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    _same(jtext.read_text(str(tmp_path / "j.txt"), firstcol=3, skip=1),
          ttext.read_text(str(tmp_path / "t.txt"), firstcol=3, skip=1))
    _same(jtext.maf2meansd(np.array([0.1, 0.4])),
          ttext.maf2meansd(np.array([0.1, 0.4])))


def test_native_codes_match(small_plink):
    """The port loads the same csrc/libbedio.so by path (or falls back
    to the same numpy code); either way the codes agree."""
    from flashpca_tpu_torch.io import cbed

    root, geno = small_plink
    ds = tplink.PlinkDataset.open(root)
    packed = ds.read_packed()
    want = jplink.unpack_codes(packed, ds.n_samples)
    if cbed.available():
        _same(cbed.codes(packed, ds.n_samples), want)
        assert os.path.basename(cbed._find_lib()) == "libbedio.so"
    _same(tplink.unpack_codes(packed, ds.n_samples), want)
