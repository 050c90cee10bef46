"""The frozen generator and the reference's decode, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen, reference

STRUCT = {"cohort_seed": 7, "pops": 8, "maf_lo": 0.05, "maf_hi": 0.5,
          "shift_sd": 0.05,
          "missing_per_10000": 100}


def unpack(packed: np.ndarray, n: int) -> np.ndarray:
    """(p, nbytes) bytes -> (p, n) PLINK codes, one sample at a time."""
    p = packed.shape[0]
    out = np.empty((p, n), dtype=np.uint8)
    for i in range(n):
        out[:, i] = (packed[:, i // 4] >> (2 * (i % 4))) & 3
    return out


def packed(n, p, seed):
    return gen.generate(n, p, seed, STRUCT, "cpu").packed


def test_deterministic_in_seed():
    a = packed(1001, 4148, 2**31 + 3)
    b = packed(1001, 4148, 2**31 + 3)
    c = packed(1001, 4148, 2**31 + 4)
    assert a.shape == (4148, 251) and a.dtype == torch.uint8
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("axis", ["snps", "samples"])
def test_every_seed_holds_the_cohort_in_another_order(axis):
    n, p = 1001, 4148          # four whole blocks and a part, a part byte
    a = gen.generate(n, p, 5, STRUCT, "cpu", axis=axis)
    b = gen.generate(n, p, 2**33 + 1, STRUCT, "cpu", axis=axis)
    ca, cb = (unpack(x.packed.numpy(), n) for x in (a, b))
    assert not np.array_equal(ca, cb)
    base_a = np.empty_like(ca)
    base_a[np.ix_(a.snp_index, a.sample_index)] = ca
    base_b = np.empty_like(cb)
    base_b[np.ix_(b.snp_index, b.sample_index)] = cb
    np.testing.assert_array_equal(base_a, base_b)
    assert sorted(a.snp_index) == list(range(p))
    assert sorted(a.sample_index) == list(range(n))
    # the other axis keeps the cohort's order
    other = a.sample_index if axis == "snps" else a.snp_index
    assert list(other) == list(range(len(other)))


def test_moments_match_a_numpy_count():
    n = 1001
    pk = packed(n, 300, 9)
    codes = unpack(pk.numpy(), n)
    good = codes != 1
    dos = np.select([codes == 0, codes == 2], [2.0, 1.0], 0.0)
    ngood, dsum, d2sum = gen.moments(pk, n)
    np.testing.assert_array_equal(ngood, good.sum(axis=1))
    np.testing.assert_array_equal(dsum, dos.sum(axis=1))
    np.testing.assert_array_equal(d2sum, (dos ** 2).sum(axis=1))
    # byte padding past sample n stays code 0 and is not counted
    assert (unpack(pk.numpy(), 1004)[:, n:] == 0).all()


def test_missing_share_and_populations():
    n = 4000
    drawn = gen.generate(n, 400, 21, STRUCT, "cpu")
    codes = np.empty((400, n), dtype=np.uint8)
    codes[:, drawn.sample_index] = unpack(drawn.packed.numpy(), n)
    share = (codes == 1).mean()
    assert 0.008 < share < 0.012
    # allele frequencies differ between populations by about shift_sd
    dos = np.select([codes == 0, codes == 2], [2.0, 1.0], 0.0)
    f = np.stack([dos[:, k::8].mean(axis=1) / 2 for k in range(8)], 1)
    assert 0.02 < np.std(f - f.mean(axis=1, keepdims=True)) < 0.08


def test_reference_decode_and_stats():
    n, p = 1003, 200
    pk = packed(n, p, 4)
    codes = unpack(pk.numpy(), n)
    np.testing.assert_array_equal(reference.codes(pk, n).numpy(), codes)
    dos = np.select([codes == 0, codes == 2, codes == 3], [2.0, 1.0, 0.0],
                    np.nan)
    mean = np.nanmean(dos, axis=1)
    sd = np.sqrt(2 * (mean / 2) * (1 - mean / 2))
    X = np.nan_to_num((dos - mean[:, None]) / sd[:, None])
    m, inv = reference.binom2_stats(pk, n, rows=64)
    np.testing.assert_allclose(m.numpy(), mean, rtol=1e-13)
    np.testing.assert_allclose(inv.numpy(), 1 / sd, rtol=1e-13)
    W = reference.standardized(pk, n, m, inv).numpy()
    np.testing.assert_allclose(W, X, rtol=1e-12, atol=1e-12)
    U = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)))
    XXU = reference.gram_columns(pk, n, m, inv, U, rows=37).numpy()
    np.testing.assert_allclose(XXU, X.T @ (X @ U.numpy()), rtol=1e-10)
    z, xu = reference.cross_and_prod(pk, n, m, inv, U,
                                     torch.ones((p, 2), dtype=torch.float64),
                                     rows=64)
    np.testing.assert_allclose(z.numpy(), X @ U.numpy(), rtol=1e-10)
    np.testing.assert_allclose(xu.numpy()[:, 0], X.sum(axis=0), rtol=1e-10)


def test_residual_statistic():
    rng = np.random.default_rng(1)
    U = torch.as_tensor(rng.standard_normal((50, 4)))
    XXU = torch.as_tensor(rng.standard_normal((50, 4)))
    d = rng.random(4)
    got = reference.residual_err(XXU, U, d, 10.0)
    R = XXU.numpy() / 10.0 - U.numpy() * d
    np.testing.assert_allclose(got, (R ** 2).sum(axis=0), rtol=1e-14)
