"""The port's kernel wrappers (kernels/packed_matvec.py) against the JAX
package's Pallas kernels, and its functional core against the JAX jnp
core.

On the CPU each wrapper runs its plain PyTorch version (the same decode
and chunked TwoSum accumulation as the CUDA kernel); the JAX side runs
the Pallas kernels in interpret mode.  Fixture as test_pallas_kernels.py:
p_pad 512, nbytes_pad 128, the last 7 invsd zeroed.  Tolerances: plain
float32 vs plain float32 at rtol 2e-5 / atol 2e-4 (the Pallas tests'
own bar: two float32 accumulation orders over 512 terms); the two-float
gram at rel < 5e-6 of the float64 product; float64 cores at 1e-12.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds each kernel against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flashpca_tpu.kernels import packed_matvec as jpk
from flashpca_tpu.ops import operator as jop
from flashpca_tpu.ops.compensated import code_value_luts
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.ops.compensated import decode_lut
from flashpca_tpu_torch.ops import operator as top

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fix():
    rng = np.random.default_rng(3)
    p_pad, nbytes_pad = 512, 128
    packed = rng.integers(0, 256, size=(p_pad, nbytes_pad), dtype=np.uint8)
    mean = rng.uniform(0.1, 1.9, p_pad).astype(np.float32)
    invsd = rng.uniform(0.5, 2.0, p_pad).astype(np.float32)
    invsd[-7:] = 0.0
    return packed, mean, invsd, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=2e-5, atol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_crossprod_plain_matches_pallas(fix, k):
    packed, mean, invsd, rng = fix
    x = rng.standard_normal((packed.shape[1] * 4, k)).astype(np.float32)
    want = jpk.crossprod_p(jnp.asarray(packed), jnp.asarray(mean),
                           jnp.asarray(invsd), jnp.asarray(x), interpret=True)
    got = tpk.crossprod_p(_t(packed), _t(mean), _t(invsd), _t(x))
    _close(got, want)


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_matvec_plain_matches_pallas(fix, k):
    packed, mean, invsd, rng = fix
    v = rng.standard_normal((packed.shape[0], k)).astype(np.float32)
    want = jpk.matvec_p(jnp.asarray(packed), jnp.asarray(mean),
                        jnp.asarray(invsd), jnp.asarray(v), interpret=True)
    got = tpk.matvec_p(_t(packed), _t(mean), _t(invsd), _t(v))
    _close(got, want)


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_gram_plain_matches_pallas(fix, k):
    packed, mean, invsd, rng = fix
    x = rng.standard_normal((packed.shape[1] * 4, k)).astype(np.float32)
    want = jpk.gram_matvec_p(jnp.asarray(packed), jnp.asarray(mean),
                             jnp.asarray(invsd), jnp.asarray(x),
                             interpret=True)
    got = tpk.gram_matvec_p(_t(packed), _t(mean), _t(invsd), _t(x))
    # the gram compounds two 512/128-term float32 contractions (the
    # Pallas tests hold their gram at the same 10x looser bar)
    _close(got, want, rtol=2e-4, atol=2e-3)


def _ff_fixture(fix):
    packed, mean, invsd, rng = fix
    # exact float64 stats whose float32 rounding is the fixture's
    m64 = mean.astype(np.float64)
    sd = np.divide(1.0, invsd.astype(np.float64),
                   out=np.zeros(invsd.shape), where=invsd > 0)
    lh, ll = code_value_luts(m64, sd)
    return packed, lh, ll, m64, sd, rng


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_gram_ff_plain_matches_pallas_and_f64(fix, k):
    packed, lh, ll, m64, sd, rng = _ff_fixture(fix)
    x = rng.standard_normal((packed.shape[1] * 4, k)).astype(np.float32)
    jh, jl = jpk.gram_ff_p(jnp.asarray(packed), jnp.asarray(lh),
                           jnp.asarray(ll), jnp.asarray(x), interpret=True)
    th, tl = tpk.gram_ff_p(_t(packed), _t(lh), _t(ll), _t(x))
    got = th.double().numpy() + tl.double().numpy()
    want_j = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # float64 oracle: W from the exact two-float tables
    W = (decode_lut(_t(packed), _t(lh).double(), torch.float64)
         + decode_lut(_t(packed), _t(ll).double(), torch.float64)).numpy()
    ref = W.T @ (W @ x.astype(np.float64))
    scale = np.linalg.norm(ref)
    assert np.linalg.norm(got - ref) / scale < 5e-6
    assert np.linalg.norm(got - want_j) / scale < 5e-6
    # the two halves individually track the Pallas kernels' halves
    _close(th, jh, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("k", [1, 3, 16])
def test_f64_functional_core_matches_jnp(fix, k):
    packed, mean, invsd, rng = fix
    m, i = mean.astype(np.float64), invsd.astype(np.float64)
    x = rng.standard_normal((packed.shape[1] * 4, k))
    v = rng.standard_normal((packed.shape[0], k))
    J = (jnp.asarray(packed), jnp.asarray(m), jnp.asarray(i))
    T = (_t(packed), _t(m), _t(i))
    pairs = [
        (jop.gram_matvec_p(*J, jnp.asarray(x), block_size=128),
         top.gram_matvec_p(*T, _t(x), block_size=128)),
        (jop.crossprod_p(*J, jnp.asarray(x), block_size=256),
         top.crossprod_p(*T, _t(x), block_size=256)),
        (jop.matvec_p(*J, jnp.asarray(v), block_size=64),
         top.matvec_p(*T, _t(v), block_size=64)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        got = got.numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    valid = np.ones(packed.shape[1] * 4)
    want = np.asarray(jop.snp_sumsq_p(*J, jnp.asarray(valid), block_size=128))
    got = top.snp_sumsq_p(*T, _t(valid), block_size=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for rows, n4, cap in ((512, 512, None), (100, 1 << 20, None),
                          (97, 4096, 16)):
        assert (top.budget_block_size(rows, n4, cap=cap)
                == jop.budget_block_size(rows, n4, cap=cap))


def test_wrappers_reject_bad_operands(fix):
    packed, mean, invsd, _ = fix
    with pytest.raises(ValueError):
        tpk.crossprod_p(_t(packed), _t(mean), _t(invsd),
                        torch.zeros((7, 2)))
    with pytest.raises(ValueError):
        tpk.matvec_p(_t(packed), _t(mean), _t(invsd), torch.zeros((7, 2)))


def test_column_chunks_cover_wide_panels():
    assert tpk._widths(3) == [(0, 3, 8)]
    assert tpk._widths(16) == [(0, 16, 16)]
    assert tpk._widths(24) == [(0, 24, 24)]
    assert tpk._widths(40) == [(0, 32, 32), (32, 40, 8)]
