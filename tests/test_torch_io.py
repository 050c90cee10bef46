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


# ---------------------------------------------------------------------------
# the host repack (subset_samples) and the byte-counted moments
# ---------------------------------------------------------------------------

def _geno(n, p, seed):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.1] = np.nan       # missing calls
    geno[:, 1] = np.nan                                 # all missing
    return geno


def _subsets(n, seed):
    rng = np.random.default_rng(seed)
    return {"mask": rng.uniform(size=n) < 0.7,
            "sorted": np.sort(rng.choice(n, size=n // 3, replace=False)),
            "unordered": rng.permutation(n)[: n // 2 + 1],
            "one": np.array([n - 1])}


@pytest.mark.parametrize("subset", ["mask", "sorted", "unordered", "one"])
@pytest.mark.parametrize("n", [40, 41, 42, 43])
def test_subset_samples_bytes_match_jax(tmp_path, n, subset):
    """The port's repack (table unpack, column gather, word pack, on
    worker threads) writes the JAX package's .bed/.bim/.fam byte for
    byte, on every n % 4 of the source and of the subset, with missing
    calls, in blocks of 5 SNPs that the 13 SNPs cross twice."""
    root = str(tmp_path / "src")
    jplink.write_bed(root, _geno(n, 13, n))
    idx = _subsets(n, n)[subset]
    jplink.subset_samples(jplink.PlinkDataset.open(root), idx,
                          str(tmp_path / "j"), block_size=5)
    tplink.subset_samples(tplink.PlinkDataset.open(root), idx,
                          str(tmp_path / "t"), block_size=5)
    for ext in (".bed", ".bim", ".fam"):
        assert ((tmp_path / ("j" + ext)).read_bytes()
                == (tmp_path / ("t" + ext)).read_bytes()), ext


@pytest.mark.parametrize("n", [40, 41, 42, 43])
def test_subset_samples_many_matches_jax(tmp_path, n):
    """Train and test from one read of the source (blocks of 5 SNPs
    that the 13 SNPs cross twice) are the JAX package's two
    ``subset_samples`` filesets byte for byte; a bad subset among them
    raises before any file is written."""
    root = str(tmp_path / "src")
    jplink.write_bed(root, _geno(n, 13, n))
    train = _subsets(n, n)["mask"]
    ds = tplink.PlinkDataset.open(root)
    subsets = [(train, str(tmp_path / "t_tr")),
               (np.flatnonzero(~train), str(tmp_path / "t_te"))]
    assert tplink.subset_samples_many(ds, subsets, block_size=5) == [
        r for _, r in subsets]
    dj = jplink.PlinkDataset.open(root)
    for idx, tag in ((train, "tr"), (np.flatnonzero(~train), "te")):
        jplink.subset_samples(dj, idx, str(tmp_path / ("j_" + tag)),
                              block_size=5)
        for ext in (".bed", ".bim", ".fam"):
            assert ((tmp_path / ("j_" + tag + ext)).read_bytes()
                    == (tmp_path / ("t_" + tag + ext)).read_bytes()), ext
    x_tr = (train, str(tmp_path / "x_tr"))
    for bad in (([], str(tmp_path / "x_te")),      # an empty subset
                ([0], root)):                      # the source's root
        with pytest.raises(ValueError):
            tplink.subset_samples_many(ds, [x_tr, bad])
    assert not (tmp_path / "x_tr.bed").exists()


@pytest.mark.parametrize("n", [1000, 1001, 1002, 1003])
def test_repack_threads_and_codes_match_jax(monkeypatch, tmp_path, n):
    """With work items of a few rows (so that the rows run on several
    threads), the repack, ``pack_codes`` and ``unpack_codes`` equal the
    JAX package's on codes 0-3 in every position, and the source's
    padding bits do not leak into the subset's last byte."""
    monkeypatch.setattr(tplink, "_CHUNK_BYTES", 3 * n)
    rng = np.random.default_rng(n)
    p = 50
    codes = rng.integers(0, 4, size=(p, n)).astype(np.uint8)
    packed = jplink.pack_codes(codes, n)
    _same(tplink.pack_codes(codes, n), packed)
    _same(tplink.unpack_codes(packed, n), jplink.unpack_codes(packed, n))
    if n % 4:
        packed[:, -1] |= np.uint8(0xFF << (2 * (n % 4)) & 0xFF)
    root = str(tmp_path / "src")
    tplink.write_bed(root, np.zeros((n, p)))
    with open(root + ".bed", "r+b") as fh:
        fh.seek(3)
        fh.write(packed.tobytes())
    idx = np.flatnonzero(rng.uniform(size=n) < 0.8)
    jplink.subset_samples(jplink.PlinkDataset.open(root), idx,
                          str(tmp_path / "j"))
    tplink.subset_samples(tplink.PlinkDataset.open(root), idx,
                          str(tmp_path / "t"))
    assert (tmp_path / "j.bed").read_bytes() == (tmp_path / "t.bed").read_bytes()
    ds = tplink.PlinkDataset.open(str(tmp_path / "t"))
    _same(ds.read_codes(), codes[:, idx])


@pytest.mark.parametrize("n", [40, 41, 42, 43])
def test_moments_without_native_match_jax(monkeypatch, tmp_path, n):
    """Without the native library the port counts the moments on the
    packed bytes (popcounts, on threads): the JAX package's exact
    float64 moments and stats, padding bits set or not."""
    from flashpca_tpu_torch.io import cbed

    monkeypatch.setattr(cbed, "available", lambda: False)
    monkeypatch.setattr(cbed, "moments_available", lambda: False)
    monkeypatch.setattr(tplink, "_CHUNK_BYTES", 64)
    root = str(tmp_path / "g")
    jplink.write_bed(root, _geno(n, 13, 7 * n))
    dj = jplink.PlinkDataset.open(root)
    want = tplink.snp_moments_from_codes(jplink.unpack_codes(
        dj.read_packed(), n))
    for a, b in zip(tplink.PlinkDataset.open(root).snp_moments(), want):
        _same(a, b)
    for a, b in zip(dj.snp_moments(), want):
        _same(a, b)
    packed = dj.read_packed().copy()
    if n % 4:
        packed[:, -1] |= np.uint8(0xFF << (2 * (n % 4)) & 0xFF)
    for a, b in zip(tplink.snp_moments_from_packed(packed, n), want):
        _same(a, b)
    for method in ("binom", "binom2"):
        for a, b in zip(tplink.PlinkDataset.open(root).snp_stats(method),
                        dj.snp_stats(method)):
            _same(a, b)


def test_repack_times_tool(monkeypatch, capsys):
    """``tools/repack_times.py`` at a small size, with work items of a
    few rows so that two threads share them: its repacks agree across
    thread counts and with one read, and it restores what it changed."""
    import json

    from flashpca_tpu_torch.io import cbed
    from flashpca_tpu_torch.tools import repack_times

    monkeypatch.setattr(tplink, "_CHUNK_BYTES", 4 * 1001 * 3)
    before = (cbed.available, tplink._THREADS)
    assert repack_times.main(["--snps", "40", "--samples", "1001",
                              "--threads", "1,2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["by_threads"]) == {"1", "2"}
    assert all(t["one_read_s"] is not None
               for t in out["by_threads"].values())
    assert 0 < out["kept"] < 1001 and out["source_bytes"] == 40 * 251
    assert (cbed.available, tplink._THREADS) == before
