"""The kernel sweep's kernels (kernels/crossprod_variants.py) and tool
(tools/kernel_sweep.py) against the JAX sweep,
.claude/skills/verify/kernel_sweep.py.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the sweep's Pallas variants in interpret mode.  Fixture as
test_torch_kernels.py but with nbytes_pad 2,048 (four 512-byte tiles, so
the Pallas kernels' accumulation across grid steps runs): p_pad 512, the
last 7 invsd zeroed.  Tolerances: rtol 2e-5 and the Pallas tests' atol
2e-4 for 512 terms, grown like the rounding of a float32 sum of
random-sign terms, sqrt(length / 512), as chip_smoke.py's plain_bar: 8e-4
for the 8,192-term contraction here, and for V3 (split3), whose three
products are three such contractions, sqrt(3) times that.  (At atol 2e-4
the plain versions of B1, V1, V2 and V4 miss the interpreted Pallas
kernels by up to 1.9e-4 beyond rtol on these shapes, and V3's by up to
7.3e-4: two float32 accumulation orders.)  Against float64: 1e-5
relative (B1's bar on the card), and 5e-5 for V3, whose dropped lo*lo
term leaves ~5e-6 here.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
each against its plain version there.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from flashpca_tpu.kernels import packed_matvec as jpk
from flashpca_tpu_torch.kernels import crossprod_variants as cv
from flashpca_tpu_torch.kernels import packed_matvec as tpk
from flashpca_tpu_torch.tools import kernel_sweep as ks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_BAR = {"crossprod_stacked": 1e-5, "crossprod_intsub": 1e-5,
           "crossprod_nocomp": 1e-5, "crossprod_split3": 5e-5,
           "crossprod_stacked_v1": 1e-5, "crossprod_intsub_v1": 1e-5,
           "crossprod_nocomp_v1": 1e-5, "crossprod_split3_v1": 5e-5}
PRODUCTS = {"crossprod_split3": 3}


def _atol(name, length):
    """The Pallas tests' atol for 512 terms, grown by sqrt(terms / 512)
    for ``PRODUCTS`` contractions of ``length`` terms."""
    return 2e-4 * max(1.0, (PRODUCTS.get(name, 1) * length / 512) ** 0.5)


@pytest.fixture(scope="module")
def jsweep():
    """The JAX sweep as a module.  It puts its own checkout on sys.path,
    so flashpca_tpu is imported first (the module cache then holds the
    checkout under test) and sys.path is restored afterwards."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_kernel_sweep",
            os.path.join(REPO, ".claude", "skills", "verify", "kernel_sweep.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def fix():
    rng = np.random.default_rng(3)
    p_pad, nbytes_pad = 512, 2048
    packed = rng.integers(0, 256, size=(p_pad, nbytes_pad), dtype=np.uint8)
    mean = rng.uniform(0.1, 1.9, p_pad).astype(np.float32)
    invsd = rng.uniform(0.5, 2.0, p_pad).astype(np.float32)
    invsd[-7:] = 0.0
    return packed, mean, invsd, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_variant(jsweep, name, packed, mean, invsd, xt):
    """The sweep's Pallas variant ``name`` on plane-major xt (4, k, nb),
    in interpret mode; returns z (p, k)."""
    m, i = jnp.asarray(mean), jnp.asarray(invsd)
    coeffs = (jsweep._coeff_rows_intsub(m, i) if name == "crossprod_intsub"
              else jpk._coeff_rows(m, i))
    with pltpu.force_tpu_interpret_mode():
        zt = getattr(jsweep, name)(jnp.asarray(packed), coeffs,
                                   jnp.asarray(xt))
    return np.asarray(zt).T


def _f64_product(packed, mean, invsd, xp):
    """float64 W xp, W the standardized values of the float32 stats:
    (dosage - m) i for codes 0, 2, 3 (dosage 2, 1, 0), 0 for missing."""
    m = mean.astype(np.float64)[:, None]
    i = invsd.astype(np.float64)[:, None]
    cols = []
    for s in range(4):
        c = (packed >> (2 * s)) & 3
        d = np.choose(c, [2.0, 0.0, 1.0, 0.0])
        cols.append(np.where(c == 1, 0.0, (d - m) * i))
    return np.concatenate(cols, axis=1) @ xp.astype(np.float64)


@pytest.mark.parametrize("name", list(cv.VARIANTS))
@pytest.mark.parametrize("k", [8, 16])
def test_variant_plain_matches_pallas(jsweep, fix, name, k):
    packed, mean, invsd, rng = fix
    xt = rng.standard_normal((4, k, packed.shape[1])).astype(np.float32)
    want = _jax_variant(jsweep, name, packed, mean, invsd, xt)
    xp = ks.planes_to_permuted(xt, "cpu")
    wrapper, plain = cv.VARIANTS[name]
    got = wrapper(_t(packed), _t(mean), _t(invsd), xp)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=_atol(name, xp.shape[0]))
    np.testing.assert_array_equal(
        got.numpy(), plain(_t(packed), _t(mean), _t(invsd), xp).numpy())
    ref = _f64_product(packed, mean, invsd, xp.numpy())
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < F64_BAR[name]


@pytest.mark.parametrize("first", list(cv.FIRST_DESIGNS))
@pytest.mark.parametrize("k", [8, 16])
def test_first_design_plain_matches_pallas(jsweep, fix, first, k):
    """The first designs of V1-V4 (``crossprod_stacked_v1_p``,
    ``crossprod_intsub_v1_p``, ``crossprod_nocomp_v1_p``,
    ``crossprod_split3_v1_p``) on the CPU: their redesign's plain version
    bit for bit, so the sweep's Pallas kernel in interpret mode at the
    bars above (V3's three products at sqrt(3) x the atol), and float64
    at their redesign's bar."""
    packed, mean, invsd, rng = fix
    xt = rng.standard_normal((4, k, packed.shape[1])).astype(np.float32)
    wrapper, _ = cv.FIRST_DESIGNS[first]
    redesign = first.removesuffix("_v1")
    want = _jax_variant(jsweep, redesign, packed, mean, invsd, xt)
    xp = ks.planes_to_permuted(xt, "cpu")
    got = wrapper(_t(packed), _t(mean), _t(invsd), xp)
    np.testing.assert_array_equal(
        got.numpy(),
        cv.VARIANTS[redesign][0](_t(packed), _t(mean), _t(invsd), xp).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=_atol(redesign, xp.shape[0]))
    ref = _f64_product(packed, mean, invsd, xp.numpy())
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < F64_BAR[first]


def test_coeff_rows_intsub_bit_equal(jsweep, fix):
    _, mean, invsd, _ = fix
    want = jsweep._coeff_rows_intsub(jnp.asarray(mean), jnp.asarray(invsd))
    got = cv.coeff_rows_intsub(_t(mean), _t(invsd))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


def test_split_bf16_bit_equal(jsweep, fix):
    rng = fix[3]
    a = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    a[:3] = (0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -9))   # ties and zero
    jh, jl = jsweep._split_bf16(jnp.asarray(a))
    th, tl = cv.split_bf16(_t(a))
    for t_, j_ in ((th, jh), (tl, jl)):
        np.testing.assert_array_equal(
            t_.view(torch.int16).numpy(),
            np.asarray(j_).view(np.int16))
    # hi + lo carries a float32 value to ~2^-16 of it
    back = th.double() + tl.double()
    assert float(((back - _t(a).double()).abs()
                  / _t(a).double().abs().clamp_min(1e-30)).max()) < 2.0 ** -15


def test_missing_decodes_to_exactly_zero(fix):
    """V2's integer shift and V3's split leave missing (code 1) at 0.0
    exactly: a decoded plane is 0 at every missing code, and an SNP whose
    calls are all missing gives an exact zero row."""
    packed, mean, invsd, rng = fix
    pk = _t(packed.copy())
    pk[3] = 0x55                               # SNP 3: every call missing
    g = cv.coeff_rows_intsub(_t(mean), _t(invsd))
    b = tpk.coeff_rows(_t(mean), _t(invsd))
    for s in range(4):
        miss = ((pk >> (2 * s)) & 3) == 1
        w2 = cv._decode_plane_intsub(pk, s, *g)
        assert bool((w2[miss] == 0).all())
        wh, wl = cv.split_bf16(tpk._decode_plane_cubic(pk, s, *b))
        assert bool((wh[miss] == 0).all()) and bool((wl[miss] == 0).all())
    xp = torch.randn((4 * pk.shape[1], 8), generator=torch.Generator()
                     .manual_seed(1))
    for name in ("crossprod_intsub", "crossprod_split3"):
        z = cv.VARIANTS[name][0](pk, _t(mean), _t(invsd), xp)
        assert bool((z[3] == 0).all())
        assert bool((z[4] != 0).any())


@pytest.mark.parametrize("name", list(cv.VARIANTS))
def test_variant_at_odd_shape_within_f64_bar(name):
    """p % 512 != 0 and n % 4 != 0, which the JAX variants cannot take
    (they drop the rows past a multiple of their SNP tile)."""
    rng = np.random.default_rng(17)
    p, n = 333, 1001
    nb = (n + 3) // 4
    packed = rng.integers(0, 256, size=(p, nb), dtype=np.uint8)
    mean = rng.uniform(0.1, 1.9, p).astype(np.float32)
    invsd = rng.uniform(0.5, 2.0, p).astype(np.float32)
    invsd[-5:] = 0.0
    xp = rng.standard_normal((4 * nb, 11)).astype(np.float32)
    got = cv.VARIANTS[name][0](_t(packed), _t(mean), _t(invsd), _t(xp))
    assert got.shape == (p, 11)
    ref = _f64_product(packed, mean, invsd, xp)
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < F64_BAR[name]
    assert bool((got[-5:] == 0).all())


def test_tiled_wrappers_on_cpu(fix):
    packed, mean, invsd, rng = fix
    P, M, I = _t(packed), _t(mean), _t(invsd)
    xp = _t(rng.standard_normal((4 * packed.shape[1], 5)).astype(np.float32))
    v = _t(rng.standard_normal((packed.shape[0], 5)).astype(np.float32))
    for tm in cv.TILE_TM:
        np.testing.assert_array_equal(cv.crossprod_tiled_p(P, M, I, xp, tm),
                                      tpk.crossprod_p(P, M, I, xp))
    for cr in cv.TILE_CR:
        np.testing.assert_array_equal(cv.matvec_tiled_p(P, M, I, v, cr),
                                      tpk.matvec_p(P, M, I, v))
    with pytest.raises(ValueError):
        cv.crossprod_tiled_p(P, M, I, xp, 1024)
    with pytest.raises(ValueError):
        cv.matvec_tiled_p(P, M, I, v, 16)
    with pytest.raises(ValueError):
        cv.crossprod_split3_p(P, M, I, v)            # not an (n4, k) panel


def test_cpu_wrappers_leave_launch_counts(fix):
    packed, mean, invsd, rng = fix
    P, M, I = _t(packed[:64, :64]), _t(mean[:64]), _t(invsd[:64])
    xp = torch.randn((256, 3))
    tpk.reset_launch_counts()
    for wrapper, _ in cv.VARIANTS.values():
        wrapper(P, M, I, xp)
    cv.crossprod_tiled_p(P, M, I, xp, 128)
    cv.matvec_tiled_p(P, M, I, torch.randn((64, 3)), 32)
    assert all(c == 0 for c in tpk.launch_counts.values())
    for name in list(cv.VARIANTS) + ["crossprod_tiled", "matvec_tiled"]:
        assert name in tpk.launch_counts


def test_tool_main_exits_nonzero_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ks.main(["512", "64", "8"]) != 0
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err
    assert captured.out == ""


def test_tool_correctness_step_on_cpu(monkeypatch):
    """The tool's data and correctness step at a tiny size: the operands
    follow the JAX sweep's numpy draws, and each variant lands within its
    float64-grade distance of B1.  The timed steps refuse the CPU."""
    data = ks.sweep_data(600, 300, 8, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        data["mean"].numpy(), rng.uniform(0.1, 1.9, 600).astype(np.float32))
    np.testing.assert_array_equal(
        data["invsd"].numpy(), rng.uniform(0.5, 2.0, 600).astype(np.float32))
    xt = rng.standard_normal((4, 8, 300)).astype(np.float32)
    np.testing.assert_array_equal(data["xp"].numpy()[300 * 2 + 7],
                                  xt[2, :, 7])       # sample 4*7 + 2
    assert data["packed"].shape == (600, 300)
    rel = ks.correctness(data)
    assert set(rel) == set(cv.VARIANTS) | set(cv.FIRST_DESIGNS)
    for name, r in rel.items():
        assert r < F64_BAR[name], (name, r)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ks.tile_sweep(data)


def test_tool_first_designs_equal_on_cpu():
    """The bit-equality step: on the CPU each redesign and its first
    design take the same plain version."""
    data = ks.sweep_data(200, 77, 8, "cpu")
    assert ks.first_designs_equal(data) == dict.fromkeys(cv.FIRST_DESIGNS,
                                                         True)


def test_tool_times_each_variant_beside_b1(monkeypatch, capsys):
    """The timed step with the clock stubbed: every kernel in turns (in
    order, then in reverse), each printed beside B1 with the difference,
    first designs labelled, and B1 less V4 as the compensation's cost."""
    data = ks.sweep_data(64, 40, 8, "cpu")
    order = ["crossprod", "crossprod_stacked", "crossprod_stacked_v1",
             "crossprod_intsub", "crossprod_intsub_v1", "crossprod_nocomp",
             "crossprod_nocomp_v1", "crossprod_split3", "crossprod_split3_v1"]
    first = dict(zip(order, [57.0, 60.0, 114.0, 57.5, 99.0, 55.0, 76.0, 15.0,
                             73.0]))
    times = iter([first[n] for n in order]
                 + [first[n] + 1.0 for n in order[::-1]])
    monkeypatch.setattr(ks, "event_ms", lambda fn, reps: (fn(), next(times))[1])
    out = ks.time_variants(data)
    assert list(out["ms"]) == order
    assert out["turns"]["crossprod_nocomp"] == [55.0, 56.0]
    assert out["ms"]["crossprod_nocomp"] == 55.5
    assert out["minus_b1_ms"]["crossprod_stacked_v1"] == 114.0 - 57.0
    assert "crossprod" not in out["minus_b1_ms"]
    assert out["compensation_ms"] == 57.5 - 55.5
    text = capsys.readouterr().out
    for label in ("V1 stacked", "V2 intsub", "V4 nocomp", "V3 split3"):
        assert f"{label}, first design" in text
    assert ("B1 - V4 nocomp = +2.00 ms: what the compensation costs B1"
            in text)
    assert "difference -2.00 ms" in text
