"""Permuted sample space and decode of the PyTorch port against the JAX
package: exactly equal for n % 4 in {0, 1, 2, 3}."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu.ops.genotypes as jg
import flashpca_tpu_torch.ops.genotypes as tg


@pytest.mark.parametrize("n", [36, 37, 38, 39])
@pytest.mark.parametrize("k", [None, 3])
def test_permute_roundtrip_exact(n, k, rng):
    nbytes = (n + 3) // 4
    shape = (n,) if k is None else (n, k)
    x = rng.standard_normal(shape)
    want = np.asarray(jg.permute_samples(jnp.asarray(x), nbytes))
    got = tg.permute_samples(torch.from_numpy(x), nbytes).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tg.permute_samples_np(x, nbytes),
                          jg.permute_samples_np(x, nbytes))
    back = tg.unpermute_samples(torch.from_numpy(want), n).numpy()
    assert np.array_equal(back, np.asarray(
        jg.unpermute_samples(jnp.asarray(want), n)))
    assert np.array_equal(back, x)
    # position s*nbytes + b holds sample 4b + s
    xp = want if k else want[:, None]
    x2 = x if k else x[:, None]
    for i in range(n):
        assert np.array_equal(xp[(i % 4) * nbytes + i // 4], x2[i])


@pytest.mark.parametrize("n", [36, 37, 38, 39])
def test_valid_mask_exact(n):
    nbytes = (n + 3) // 4
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        want = np.asarray(jg.valid_mask_permuted(n, nbytes, jd))
        got = tg.valid_mask_permuted(n, nbytes, td).numpy()
        assert np.array_equal(got, want)
        assert got.sum() == n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_decode_standardized_exact(dtype, rng):
    m, nbytes = 9, 11
    packed = rng.integers(0, 256, (m, nbytes), dtype=np.uint8)
    mean = rng.uniform(0.1, 1.9, m).astype(dtype)
    invsd = rng.uniform(0.5, 2.0, m).astype(dtype)
    invsd[2] = 0.0
    want = np.asarray(jg.decode_standardized(
        jnp.asarray(packed), jnp.asarray(mean), jnp.asarray(invsd),
        jnp.dtype(dtype)))
    got = tg.decode_standardized(
        torch.from_numpy(packed), torch.from_numpy(mean),
        torch.from_numpy(invsd), getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    codes = rng.integers(0, 4, (m, 8)).astype(np.uint8)
    sd = rng.uniform(0.0, 1.0, m)
    assert np.array_equal(tg.dense_standardized_np(codes, mean, sd),
                          jg.dense_standardized_np(codes, mean, sd))
