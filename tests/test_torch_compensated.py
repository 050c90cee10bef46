"""Compensated (two-float) arithmetic of the PyTorch port against the
JAX package (ops/compensated.py): the error-free transformations are
exact, the tables and decode bit-identical, and the chunked products
and reductions agree to the two-float accuracy (float64-grade)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flashpca_tpu.ops.compensated as jc
import flashpca_tpu_torch.ops.compensated as tc

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_error_free_transforms_exact(dtype, rng):
    a = (rng.standard_normal(1000) * 10.0 ** rng.integers(-5, 5, 1000)
         ).astype(dtype)
    b = (rng.standard_normal(1000) * 10.0 ** rng.integers(-5, 5, 1000)
         ).astype(dtype)
    s, e = tc.twosum(_t(a), _t(b))
    js, je = jc.twosum(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(e.numpy(), np.asarray(je))
    p, pe = tc.twoprod(_t(a), _t(b))
    jp, jpe = jc.twoprod(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(pe.numpy(), np.asarray(jpe))
    if dtype == np.float32:
        # exact: a*b == p + e in float64 (Dekker split 2^12+1 for f32)
        exact = a.astype(np.float64) * b.astype(np.float64)
        assert np.array_equal(p.numpy().astype(np.float64)
                              + pe.numpy().astype(np.float64), exact)


def test_sum_and_chunked_products(rng):
    parts = rng.standard_normal((7, 5, 3)).astype(np.float32)
    h, l = tc.sum_ff(_t(parts))
    jh, jl = jc.sum_ff(jnp.asarray(parts))
    assert np.array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-12)
    exact = parts.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(h.numpy() + l.numpy().astype(np.float64),
                               exact, rtol=1e-12, atol=1e-12)
    A = rng.standard_normal((5000, 4)).astype(np.float32)
    B = rng.standard_normal((5000, 3)).astype(np.float32)
    ref = A.astype(np.float64).T @ B.astype(np.float64)
    for got in (tc.matdot_ff(_t(A), _t(B)), jc.matdot_ff(jnp.asarray(A),
                                                         jnp.asarray(B))):
        g = np.asarray(got[0], np.float64) + np.asarray(got[1], np.float64)
        assert np.abs(g - ref).max() < 1e-5 * np.abs(ref).max()
    W = rng.standard_normal((6, 5000)).astype(np.float32)
    ref = W.astype(np.float64) @ B.astype(np.float64)
    th, tl = tc.rowdot_ff(_t(W), _t(B))
    g = th.double().numpy() + tl.double().numpy()
    assert np.abs(g - ref).max() < 1e-5 * np.abs(ref).max()
    for a, b in zip(tc.split_f64(ref), jc.split_f64(ref)):
        assert np.array_equal(a, b)


def test_luts_and_decode_bit_identical(rng):
    p = 40
    mean = rng.uniform(0, 2, p)
    sd = rng.uniform(0, 1, p)
    sd[:3] = 0.0
    for a, b in zip(tc.code_value_luts(mean, sd, 48),
                    jc.code_value_luts(mean, sd, 48)):
        assert np.array_equal(a, b)
    lh, ll = tc.code_value_luts(mean, sd)
    packed = rng.integers(0, 256, (p, 9), dtype=np.uint8)
    for lut in (lh, ll):
        got = tc.decode_lut(_t(packed), _t(lut)).numpy()
        want = np.asarray(jc.decode_lut(jnp.asarray(packed),
                                        jnp.asarray(lut)))
        assert np.array_equal(got, want)


def test_blocked_gram_ff_and_reductions_match_jax(rng):
    p, nb, k = 96, 40, 5
    packed = rng.integers(0, 256, (p, nb), dtype=np.uint8)
    mean = rng.uniform(0.1, 1.9, p)
    sd = rng.uniform(0.3, 0.8, p)
    lh, ll = tc.code_value_luts(mean, sd)
    x = rng.standard_normal((4 * nb, k)).astype(np.float32)
    th, tl = tc.gram_ff_p(_t(packed), _t(lh), _t(ll), _t(x), block_size=32)
    jh, jl = jc.gram_ff_p(jnp.asarray(packed), jnp.asarray(lh),
                          jnp.asarray(ll), jnp.asarray(x), block_size=32)
    got = th.double().numpy() + tl.double().numpy()
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    W = (tc.decode_lut(_t(packed), _t(lh).double(), torch.float64)
         + tc.decode_lut(_t(packed), _t(ll).double(), torch.float64)).numpy()
    ref = W.T @ (W @ x.astype(np.float64))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-6
    assert np.linalg.norm(got - want) / np.linalg.norm(ref) < 5e-6

    # the reductions get the SAME two-float pair on both sides (the two
    # gram products above differ at their own ~1e-6 level)
    U = rng.standard_normal((4 * nb, k)).astype(np.float32)
    jh_t, jl_t = _t(np.asarray(jh)), _t(np.asarray(jl))
    g_t = tc.ritz_ff(_t(U), jh_t, jl_t)
    g_j = jc.ritz_ff(jnp.asarray(U), jh, jl)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-9, atol=1e-9 * np.abs(g_j).max())
    dd = rng.uniform(1, 5, k)
    r_t = tc.residual_sums_ff(jh_t, jl_t, _t(U), dd)
    r_j = jc.residual_sums_ff(jh, jl, jnp.asarray(U), dd)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)
    np.testing.assert_allclose(tc.gram_small_ff(_t(U)),
                               jc.gram_small_ff(jnp.asarray(U)), rtol=1e-12)
