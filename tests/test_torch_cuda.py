"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card.

These tests need a CUDA device and skip without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and the plain versions accumulate in float32 in
different orders (both TwoSum-compensated across chunks), so plain
products agree at rtol 2e-5 / atol 2e-4 (the Pallas tests' bar) and
two-float pairs, compared through their float64 sums, at 5e-6 relative.
"""

import numpy as np
import pytest
import torch

from flashpca_tpu_torch.kernels import packed_matvec as tpk


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs the same comparison on the card)")
    return torch.device("cuda")


def _close(got, want, rtol=2e-5, atol=2e-4):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


def _close_pair(h1, l1, h2, l2):
    a = h1.cpu().double() + l1.cpu().double()
    b = h2.cpu().double() + l2.cpu().double()
    assert float((a - b).norm() / b.norm()) < 5e-6


def _operands(cuda, n, p, seed=11):
    g = torch.Generator().manual_seed(seed)
    nb = (n + 3) // 4
    packed = torch.randint(0, 256, (p, nb), generator=g,
                           dtype=torch.uint8).to(cuda)
    mean = (0.1 + 1.8 * torch.rand(p, generator=g)).to(cuda)
    invsd = (0.5 + 1.5 * torch.rand(p, generator=g)).to(cuda)
    invsd[-5:] = 0.0
    return packed, mean, invsd, nb


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 24, 40])
@pytest.mark.parametrize("n", [1001, 1024])
def test_kernels_match_plain(cuda, k, n):
    packed, mean, invsd, nb = _operands(cuda, n, 333)
    p = packed.shape[0]
    x = torch.randn((4 * nb, k), device=cuda)
    v = torch.randn((p, k), device=cuda)
    cpu = (packed.cpu(), mean.cpu(), invsd.cpu())
    _close(tpk.crossprod_p(packed, mean, invsd, x),
           tpk.crossprod_p(*cpu, x.cpu()))
    _close(tpk.matvec_p(packed, mean, invsd, v),
           tpk.matvec_p(*cpu, v.cpu()))
    _close(tpk.gram_matvec_p(packed, mean, invsd, x),
           tpk.gram_matvec_p(*cpu, x.cpu()), rtol=2e-4, atol=2e-3)
    lut6 = tpk.lut_rows(torch.randn(p, 4, device=cuda),
                        torch.randn(p, 4, device=cuda) * 1e-8)
    zh, zl = tpk.crossprod_ff_p(packed, lut6, x)
    ph, pl = tpk.crossprod_ff_p(packed.cpu(), lut6.cpu(), x.cpu())
    _close(zh, ph)
    _close_pair(zh, zl, ph, pl)
    yh, yl = tpk.matvec_ff_p(packed, lut6, v, v * 1e-8)
    qh, ql = tpk.matvec_ff_p(packed.cpu(), lut6.cpu(), v.cpu(),
                             v.cpu() * 1e-8)
    _close(yh, qh)
    _close_pair(yh, yl, qh, ql)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 28])
@pytest.mark.parametrize("n", [1001, 4096])
def test_tall_kernels_match_plain(cuda, k, n):
    """B5 and the tall two-float gram (B5, mask, B3, B1) against their
    plain versions; the gram's hi halves at the gram bar of
    tests/test_torch_kernels.py (two compounded contractions)."""
    from flashpca_tpu_torch.ops.genotypes import valid_mask_permuted

    packed, mean, invsd, nb = _operands(cuda, n, 333)
    p = packed.shape[0]
    v = torch.randn((p, k), device=cuda)
    lh = torch.randn(p, 4, device=cuda)
    ll = torch.randn(p, 4, device=cuda) * 1e-8
    lut6 = tpk.lut_rows(lh, ll)
    tpk.reset_launch_counts()
    yh, yl = tpk.matvec_ff_novl_p(packed, lut6, v)
    assert tpk.launch_counts["matvec_ff_novl"] == 1
    assert tpk.launch_counts["matvec_ff"] == 0
    qh, ql = tpk.matvec_ff_novl_p(packed.cpu(), lut6.cpu(), v.cpu())
    _close(yh, qh)
    _close_pair(yh, yl, qh, ql)
    valid = valid_mask_permuted(n, nb, torch.float32, cuda)
    zh, zl = tpk.gram_tall_ff_p(packed, lh, ll, mean, invsd, v, valid)
    ph, pl = tpk.gram_tall_ff_p(packed.cpu(), lh.cpu(), ll.cpu(),
                                mean.cpu(), invsd.cpu(), v.cpu(),
                                valid.cpu())
    _close(zh, ph, rtol=2e-4, atol=2e-3)
    _close_pair(zh, zl, ph, pl)


@pytest.mark.cuda
def test_kernels_count_launches_and_refuse_float64(cuda):
    packed, mean, invsd, nb = _operands(cuda, 100, 40)
    tpk.reset_launch_counts()
    tpk.gram_matvec_p(packed, mean, invsd, torch.randn((4 * nb, 40),
                                                       device=cuda))
    assert tpk.launch_counts["crossprod"] == 2     # two column chunks
    assert tpk.launch_counts["matvec"] == 2
    with pytest.raises(NotImplementedError):
        tpk.crossprod_p(packed, mean, invsd,
                        torch.randn((4 * nb, 2), device=cuda,
                                    dtype=torch.float64))


@pytest.mark.cuda
def test_pca_on_card_matches_cpu_float64(cuda, tmp_path):
    from flashpca_tpu_torch import PlinkDataset, check, pca
    from flashpca_tpu_torch.io.plink import write_bed

    rng = np.random.default_rng(5)
    n, p, pops = 803, 450, 4
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0, 0.15, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, np.arange(n) % pops].T).astype(float)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / "d")
    write_bed(root, geno)
    ds = PlinkDataset.open(root)
    r32 = pca(ds, 5, device=cuda)
    r64 = pca(ds, 5, device="cpu")
    assert np.allclose(r32.values, r64.values, rtol=1e-6)
    dots = np.abs(np.sum(r32.vectors * r64.vectors, axis=0))
    assert np.all(dots > 1 - 1e-6)
    assert check(ds, r32.vectors, r32.values, device=cuda).mse < 1e-8


@pytest.mark.cuda
def test_tall_pca_on_card_matches_cpu_float64(cuda, tmp_path):
    from flashpca_tpu_torch import PlinkDataset, pca
    from flashpca_tpu_torch.io.plink import write_bed

    rng = np.random.default_rng(6)
    n, p, pops = 2003, 300, 4
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0, 0.15, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, np.arange(n) % pops].T).astype(float)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / "t")
    write_bed(root, geno)
    ds = PlinkDataset.open(root)
    tpk.reset_launch_counts()
    r32 = pca(ds, 5, device=cuda)                    # n > 2p: the tall path
    assert all(tpk.launch_counts[k] > 0 for k in
               ("crossprod", "matvec", "crossprod_ff", "matvec_ff_novl"))
    r64 = pca(ds, 5, device="cpu", operator_mode="tall")
    assert np.allclose(r32.values, r64.values, rtol=1e-6)
    dots = np.abs(np.sum(r32.vectors * r64.vectors, axis=0))
    assert np.all(dots > 1 - 1e-6)
