"""The capped float32 schedule's bulk eigenvalues: the port against the
JAX package on the same dense matrix.

On the dense headline the float32 ``polish="contract"`` run leaves the
Marchenko-Pastur bulk eigenvalues a little below a float64 solve.  This
test asks whether that shortfall belongs to the port or to the schedule
both packages share: the same 2,048 x 4,096 genotype matrix from 8
planted populations (seed 16) goes through both packages' ``pca`` at
float32 with k = 20, and each result is held to float64 ``eigh`` of
X X^T / p.

Bars:

* the 7 population eigenvalues: within 1e-6 of the largest, in both;
* the 13 bulk eigenvalues: the port's largest shortfall (as a share of
  the largest eigenvalue) at most 2 x the JAX package's + 1e-6.  Both
  readings are printed (``-s``); on this matrix both are about 7.4e-6.
"""

import numpy as np
import torch

import jax.numpy as jnp

import flashpca_tpu as fj
import flashpca_tpu_torch as ft
from flashpca_tpu_torch.ops.standardize import standardize

torch.set_num_threads(2)

N, P, POPS, K = 2048, 4096, 8, 20


def _planted(seed=16):
    rng = np.random.default_rng(seed)
    w = 0.8 ** np.arange(POPS)
    pop = rng.choice(POPS, size=N, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, P)[:, None]
                   + rng.normal(0.0, 0.1, (P, POPS)), 0.02, 0.98)
    return rng.binomial(2, freq[:, pop].T).astype(np.float64)


def test_float32_bulk_shortfall_is_shared_with_jax():
    geno = _planted()
    X = standardize(geno, "binom2")[0]
    lam = np.linalg.eigvalsh(X @ X.T / P)[::-1][:K]
    rj = fj.pca(geno, K, dtype=jnp.float32, polish="contract")
    rt = ft.pca(geno, K, device="cpu", dtype=torch.float32,
                polish="contract")
    assert rj.converged and rt.converged
    pops = slice(0, POPS - 1)
    bulk = slice(POPS - 1, K)
    short = {}
    for who, r in (("jax", rj), ("port", rt)):
        off = (r.values - lam) / lam[0]
        assert np.abs(off[pops]).max() <= 1e-6, (who, off[pops])
        short[who] = float(-off[bulk].min())
        print(f"{who}: largest bulk shortfall {short[who]:.3e} of the "
              f"largest eigenvalue; population pairs within "
              f"{np.abs(off[pops]).max():.1e}")
    assert short["port"] <= 2.0 * short["jax"] + 1e-6, short
