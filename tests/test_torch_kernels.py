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


@pytest.mark.parametrize("k, want", [
    (1, [(0, 1, 1)]),
    (33, [(0, 32, 32), (32, 33, 1)]),
    (65, [(0, 32, 32), (32, 64, 32), (64, 65, 1)]),
    (2, [(0, 2, 8)]),
    (3, [(0, 3, 8)]),
    (8, [(0, 8, 8)]),
    (16, [(0, 16, 16)]),
    (24, [(0, 24, 24)]),
    (40, [(0, 32, 32), (32, 40, 8)]),
])
def test_one_column_chunks_take_the_narrow_kernels(k, want):
    """B1's and B2's launches: a one-column chunk at KC 1 (the one-column
    kernels), every other chunk at _widths' kc 8-32; the first designs
    (``narrow=False``) keep _widths' chunks, kc 8 for one column."""
    assert tpk._launches(k) == want
    assert tpk._launches(k, narrow=False) == tpk._widths(k)


def _launch_spies(monkeypatch):
    """Stand-ins for the kernel launches and the padded copy, recording
    what each chunk of a product launched: ("narrow", column length,
    contiguous) or ("kc", kc), and ("padded", kc)."""
    calls = []

    def narrow(rows):
        def launch(packed, coeffs, col):
            calls.append(("narrow", tuple(col.shape), col.is_contiguous()))
            return torch.zeros((rows, 1))
        return launch

    def panel(rows):
        def launch(packed, coeffs, x, kc, name=None):
            calls.append(("kc", kc))
            return torch.zeros((rows, kc))
        return launch

    padded = tpk._padded

    def spy(x, c0, c1, kc):
        calls.append(("padded", kc))
        return padded(x, c0, c1, kc)

    monkeypatch.setattr(tpk, "_launch_crossprod_narrow", narrow(5))
    monkeypatch.setattr(tpk, "_launch_matvec_narrow", narrow(12))
    monkeypatch.setattr(tpk, "_launch_crossprod", panel(5))
    monkeypatch.setattr(tpk, "_launch_matvec", panel(12))
    monkeypatch.setattr(tpk, "_padded", spy)
    return calls


@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("kind", ["crossprod", "matvec"])
def test_one_column_chunk_launches_without_a_padded_copy(monkeypatch, kind,
                                                         k):
    """A one-column chunk (k = 1, or the last column of 33) launches the
    one-column kernel on the column itself, made contiguous, with no
    padded copy; the 32-column chunk keeps its kc 32 launch.  Each
    chunk's output is KC columns wide (the wrappers keep c1 - c0 of
    them; the gram hands B1's to B2 as it is)."""
    calls = _launch_spies(monkeypatch)
    rows = 12 if kind == "crossprod" else 5
    x = torch.randn((rows, k))
    chunk = tpk._crossprod_chunk if kind == "crossprod" else tpk._matvec_chunk
    out = [chunk(kind, None, None, x, c0, c1, kc)
           for c0, c1, kc in tpk._launches(k)]
    want = [("narrow", (rows,), True)]
    if k == 33:
        want = [("padded", 32), ("kc", 32)] + want
    assert calls == want
    assert [o.shape[1] for o in out] == [kc for _, _, kc in
                                         tpk._launches(k)]


def _decoded64(packed, mean, invsd):
    """W (p, n4) in float64 from the float32 factored-cubic coefficients,
    permuted sample order: column s * nb + b is 2-bit field s of byte b."""
    b0, b1, b2 = (c.double()[:, None] for c in tpk.coeff_rows(mean, invsd))
    planes = []
    for s in range(4):
        t = ((packed >> (2 * s)) & 3).double()
        planes.append((t - 1.0) * (b0 + t * (b1 + t * b2)))
    return torch.cat(planes, dim=1)


@pytest.mark.parametrize("p, n", [(133, 1001), (333, 771), (40, 20004)])
def test_one_column_plain_products_match_float64(p, n):
    """One-column crossprod_p and matvec_p on the CPU (their plain
    versions, the oracle of the one-column kernels) against float64 on
    ragged p and nb, with a row of missing calls (exactly 0) and a row
    holding every code: within 1e-5 of the sum of |terms|."""
    rng = np.random.default_rng(p + n)
    nb = (n + 3) // 4
    packed = rng.integers(0, 256, (p, nb), dtype=np.uint8)
    packed[0] = 0x55
    packed[1] = np.resize(np.array([0xE4, 0x1B, 0x4E, 0xB1], np.uint8), nb)
    packed = _t(packed)
    mean = _t(rng.uniform(0.1, 1.9, p).astype(np.float32))
    invsd = _t(rng.uniform(0.5, 2.0, p).astype(np.float32))
    invsd[-3:] = 0.0
    x = _t(rng.standard_normal((4 * nb, 1)).astype(np.float32))
    v = _t(rng.standard_normal((p, 1)).astype(np.float32))
    W = _decoded64(packed, mean, invsd)
    z = tpk.crossprod_p(packed, mean, invsd, x)
    y = tpk.matvec_p(packed, mean, invsd, v)
    assert z.shape == (p, 1) and y.shape == (4 * nb, 1)
    assert float(z[0, 0]) == 0.0
    for got, want, scale in ((z, W @ x.double(), W.abs() @ x.double().abs()),
                             (y, W.T @ v.double(),
                              W.T.abs() @ v.double().abs())):
        assert bool(((got.double() - want).abs() <= 1e-5 * scale
                     + 1e-30).all())
