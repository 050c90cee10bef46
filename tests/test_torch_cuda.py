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
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 4096), (133, 771)])
def test_tall_kernels_match_plain(cuda, k, p, n):
    """B5 and the tall two-float gram (B5, mask, B3, B1) against their
    plain versions: the gram through its pairs' float64 sums, and its
    second stage, B3 on the card's own masked y_hi, by its hi halves at
    the gram bar of tests/test_torch_kernels.py (two compounded
    contractions).  The gram's own hi halves are not held to that bar:
    B5 on the card and on the CPU leave a different share of each sum
    in y_lo (their summation orders differ), and that share moves the
    gram's hi half near cancellation; the pair holds it.  B5's
    comparison entries (its first design, C = 4, CR = 128) against B5
    through the pairs' float64 sums.  k runs B5 at every KC (5 -> 8, 16,
    24, 28 -> 32).  133 x 771 is ragged on both of B5's tile axes: p =
    2 x 64 + 5 SNP rows (two full 64-row chunks, or one 128-row chunk,
    and five rows), 193 bytes = 3 x 64 + 1 (three full blocks and one
    byte).  v and the tables come from a seeded generator, so a case
    takes the same inputs whatever ran before it
    (``python -m flashpca_tpu_torch.tools.tall_gram_seeds`` runs the
    333-4096-28 case over other seeds)."""
    from flashpca_tpu_torch.ops.genotypes import valid_mask_permuted
    from flashpca_tpu_torch.tools.tall_gram_seeds import draws

    packed, mean, invsd, nb = _operands(cuda, n, p)
    v, lh, ll = (t.to(cuda) for t in draws(p, k, 12))
    lut6 = tpk.lut_rows(lh, ll)
    tpk.reset_launch_counts()
    yh, yl = tpk.matvec_ff_novl_p(packed, lut6, v)
    assert tpk.launch_counts["matvec_ff_novl"] == 1
    assert tpk.launch_counts["matvec_ff"] == 0
    assert tpk.launch_counts["matvec_ff_novl_v1"] == 0
    qh, ql = tpk.matvec_ff_novl_p(packed.cpu(), lut6.cpu(), v.cpu())
    _close(yh, qh)
    _close_pair(yh, yl, qh, ql)
    for name in tpk.NOVL_KERNELS:
        oh, ol = getattr(tpk, name + "_p")(packed, lut6, v)
        assert tpk.launch_counts[name] == 1
        _close_pair(oh, ol, yh, yl)
    assert tpk.launch_counts["matvec_ff_novl"] == 1
    valid = valid_mask_permuted(n, nb, torch.float32, cuda)
    zh, zl = tpk.gram_tall_ff_p(packed, lh, ll, mean, invsd, v, valid)
    ph, pl = tpk.gram_tall_ff_p(packed.cpu(), lh.cpu(), ll.cpu(),
                                mean.cpu(), invsd.cpu(), v.cpu(),
                                valid.cpu())
    _close_pair(zh, zl, ph, pl)
    ym = yh * valid[:, None]
    bh, bl = tpk.crossprod_ff_p(packed, lut6, ym)
    ch, cl = tpk.crossprod_ff_p(packed.cpu(), lut6.cpu(), ym.cpu())
    _close(bh, ch, rtol=2e-4, atol=2e-3)
    _close_pair(bh, bl, ch, cl)
    # the gram against a float64 gram over all its entries, held as
    # chip_smoke.py holds it (relative in norm, GRAM_F64_BAR), on the
    # exact two-float tables of mean and invsd (entry by entry, in units
    # of a column's largest |z|, an H100 reads up to 2.5e-7 at these
    # cases: ``python -m flashpca_tpu_torch.tools.tall_gram_f64``)
    from flashpca_tpu_torch.tools.tall_gram_f64 import readings

    r = readings(cuda, p, n, k)
    assert r["norm_rel"] < _chip_smoke().GRAM_F64_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28, 40])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 1024), (133, 1001),
                                 (133, 1024)])
def test_b1_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """B1 (crossprod_v2.cu) gives its first design's sums bit for bit at
    every KC (k 3, 5 -> 8; 16; 24; 28 -> 32; 40 -> 32 + 8): each output
    takes the same FMA sequence and the same TwoSum fold every 32 bytes.
    p = 133 = 2 x 64 + 5 is ragged on B1's 64-row blocks; n = 1001 gives
    251 bytes (ragged chunk, unaligned rows), n = 1024 256 (aligned)."""
    packed, mean, invsd, nb = _operands(cuda, n, p)
    x = torch.randn((4 * nb, k), device=cuda)
    tpk.reset_launch_counts()
    z = tpk.crossprod_p(packed, mean, invsd, x)
    z1 = tpk.crossprod_v1_p(packed, mean, invsd, x)
    chunks = len(tpk._widths(k))
    assert tpk.launch_counts["crossprod"] == chunks
    assert tpk.launch_counts["crossprod_v1"] == chunks
    assert torch.equal(z, z1)
    _close(z, tpk.crossprod_plain(packed.cpu(), mean.cpu(), invsd.cpu(),
                                  x.cpu()))


def _variant_is_bit_equal(cuda, name, k, p, n, atol=2e-4):
    """The redesigned variant ``name`` (crossprod_variants_v2.cu,
    crossprod_split3_v2.cu) against its first design
    (crossprod_variants.cu, crossprod_split3.cu): launch counts,
    torch.equal, an all-missing SNP (row 7) giving an exact zero row, and
    its plain version's values at ``atol``."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv

    packed, mean, invsd, nb = _operands(cuda, n, p)
    packed[7] = 0x55
    x = torch.randn((4 * nb, k), device=cuda)
    wrapper, plain = cv.VARIANTS[name]
    tpk.reset_launch_counts()
    z = wrapper(packed, mean, invsd, x)
    z1 = cv.FIRST_DESIGNS[name + "_v1"][0](packed, mean, invsd, x)
    chunks = len(tpk._widths(k))
    assert tpk.launch_counts[name] == chunks
    assert tpk.launch_counts[name + "_v1"] == chunks
    assert tpk.launch_counts["crossprod"] == 0
    assert torch.equal(z, z1)
    assert bool((z[7] == 0).all())
    _close(z, plain(packed.cpu(), mean.cpu(), invsd.cpu(), x.cpu()),
           atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28, 40])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 1024), (133, 1001),
                                 (133, 1024), (333, 1063)])
def test_v1_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """V1 (``stacked``, crossprod_variants_v2.cu) gives its first design's
    sums bit for bit at every KC (k 3, 5 -> 8; 16; 24; 28 -> 32; 40 -> 32
    + 8): each output takes the same FMA sequence over each 16-byte
    chunk's 64 samples in stacked order (plane-major) and the same TwoSum
    fold.  p = 133 is ragged on the 128-row blocks; n = 1001 gives 251
    bytes (a ragged chunk, unaligned rows), n = 1024 256 (aligned) and
    n = 1063 266, whose last 32-byte stage holds one 16-byte chunk."""
    _variant_is_bit_equal(cuda, "crossprod_stacked", k, p, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28, 40])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 1024), (133, 1001),
                                 (133, 1024), (333, 1063)])
def test_v4_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """V4 (``nocomp``, crossprod_variants_v2.cu) gives its first design's
    sums bit for bit at every KC: each output takes the same FMA sequence
    and the same plain float32 add of each 32-byte chunk's partial.
    Shapes as for V1."""
    _variant_is_bit_equal(cuda, "crossprod_nocomp", k, p, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28, 40])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 1024), (133, 1001),
                                 (133, 1024), (333, 1063)])
def test_v2_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """V2 (``intsub``, crossprod_variants_v2.cu) gives its first design's
    sums bit for bit at every KC: B1's FMA sequence and TwoSum fold every
    32 bytes, with each row's four integer-shifted values decoded once
    and picked per sample.  Shapes as for V1."""
    _variant_is_bit_equal(cuda, "crossprod_intsub", k, p, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 16, 24, 28, 40])
@pytest.mark.parametrize("p,n", [(333, 1001), (333, 1024), (133, 1001),
                                 (133, 1024), (333, 1063)])
def test_v3_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """V3 (``split3``, crossprod_split3_v2.cu) gives its first design's
    sums bit for bit at every KC: the same mma.sync products on the same
    bf16 fragments (A picked from each row's split table, B from the
    panel split by the pre-pass), in the same order within each 32-byte
    fold unit, and the same TwoSum fold.  p = 133 is ragged on the 128-row
    blocks; n = 1001 gives 251 bytes (a ragged fold unit, rows not 16-byte
    aligned), n = 1063 266, whose last 64-byte stage holds one fold
    unit.  Against its plain version at sqrt(3) x the atol: three
    products, tensor-core sums."""
    _variant_is_bit_equal(cuda, "crossprod_split3", k, p, n,
                          atol=2e-4 * 3 ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 24, 28, 32, 40])
@pytest.mark.parametrize("n", [1001, 771, 4096])
@pytest.mark.parametrize("p", [133, 333])
def test_b2_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """B2 (matvec_v2.cu) gives its first design's sums bit for bit at
    every KC (k 3 -> 8; 16; 24; 28 -> 32; 32; 40 -> 32 + 8), and so does
    the first design's tile entry at 64 rows a chunk: each output takes
    the same FMA sequence and the same TwoSum fold every 64 SNP rows.
    p = 133 = 2 x 64 + 5 and 333 = 5 x 64 + 13 are ragged on the 64-row
    chunks; n = 1001 and 771 give 251 and 193 bytes (nb % 16 != 0: rows
    staged byte by byte, a ragged last block), n = 4096 1,024."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv

    packed, mean, invsd, nb = _operands(cuda, n, p)
    v = torch.randn((p, k), device=cuda)
    tpk.reset_launch_counts()
    y = tpk.matvec_p(packed, mean, invsd, v)
    y1 = tpk.matvec_v1_p(packed, mean, invsd, v)
    chunks = len(tpk._widths(k))
    assert tpk.launch_counts["matvec"] == chunks
    assert tpk.launch_counts["matvec_v1"] == chunks
    assert torch.equal(y, y1)
    assert torch.equal(y, cv.matvec_tiled_p(packed, mean, invsd, v, 64))
    _close(y, tpk.matvec_plain(packed.cpu(), mean.cpu(), invsd.cpu(),
                               v.cpu()))


# (p, n): wide byte layouts (p of the order of n or above) and tall ones
# (n >> p); nb = 251, 193 (nb % 16 and nb % 4 != 0: bytes staged one by
# one), 1,024, 256 (aligned), 2,004 (nb % 16 != 0, nb % 4 == 0: 4-byte
# copies), 5,001 (ragged) and 4,096; p = 333, 133, 1201, 40 ragged on
# B1's 128-row blocks and B2's 64-row chunks
NARROW_SHAPES = [(333, 1001), (133, 771), (333, 4096), (1201, 1024),
                 (50, 8016), (40, 20004), (64, 16384)]


def _narrow_operands(cuda, n, p):
    """:func:`_operands` with a row of missing calls (0x55) and a row
    holding every code, missing included, in every byte position."""
    packed, mean, invsd, nb = _operands(cuda, n, p)
    packed[0] = 0x55
    packed[1] = torch.tensor([0xE4, 0x1B, 0x4E, 0xB1], dtype=torch.uint8,
                             device=cuda).repeat(nb // 4 + 1)[:nb]
    return packed, mean, invsd, nb


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", NARROW_SHAPES)
def test_narrow_kernels_are_column_zero_of_kc8(cuda, p, n):
    """B1 and B2 at one column (crossprod_narrow.cu, matvec_narrow.cu)
    give column 0 of B1 and B2 at kc 8 on the zero-padded column bit for
    bit, on wide and tall byte layouts with ragged p and nb and rows of
    every code; a one-column product launches them alone, with the
    plain versions' values."""
    packed, mean, invsd, nb = _narrow_operands(cuda, n, p)
    coeffs = tpk.coeff_rows(mean, invsd)
    x = torch.randn((4 * nb, 1), device=cuda)
    v = torch.randn((p, 1), device=cuda)
    tpk.reset_launch_counts()
    z = tpk.crossprod_p(packed, mean, invsd, x)
    y = tpk.matvec_p(packed, mean, invsd, v)
    assert tpk.launch_counts["crossprod_narrow"] == 1
    assert tpk.launch_counts["matvec_narrow"] == 1
    assert tpk.launch_counts["crossprod"] == tpk.launch_counts["matvec"] == 0
    z8 = tpk._launch_crossprod(packed, coeffs, tpk._padded(x, 0, 1, 8), 8)
    y8 = tpk._launch_matvec(packed, coeffs, tpk._padded(v, 0, 1, 8), 8)
    assert torch.equal(z, z8[:, :1]) and torch.equal(y, y8[:, :1])
    # the first designs keep kc 8 on one column, the same bits
    assert torch.equal(z, tpk.crossprod_v1_p(packed, mean, invsd, x))
    assert torch.equal(y, tpk.matvec_v1_p(packed, mean, invsd, v))
    cpu = (packed.cpu(), mean.cpu(), invsd.cpu())
    _close(z, tpk.crossprod_plain(*cpu, x.cpu()))
    _close(y, tpk.matvec_plain(*cpu, v.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(333, 1001), (1201, 1024)])
def test_narrow_kernels_take_a_panels_last_column(cuda, p, n):
    """A 33-column panel runs B1 or B2 at kc 32 and its last column
    through the one-column kernel, with the first design's bits (which
    pads that column to kc 8); a strided column is made contiguous, and
    a one-column gram runs both one-column kernels."""
    packed, mean, invsd, nb = _narrow_operands(cuda, n, p)
    x = torch.randn((4 * nb, 33), device=cuda)
    v = torch.randn((p, 33), device=cuda)
    tpk.reset_launch_counts()
    z = tpk.crossprod_p(packed, mean, invsd, x)
    y = tpk.matvec_p(packed, mean, invsd, v)
    for name in ("crossprod", "crossprod_narrow", "matvec", "matvec_narrow"):
        assert tpk.launch_counts[name] == 1
    assert torch.equal(z, tpk.crossprod_v1_p(packed, mean, invsd, x))
    assert torch.equal(y, tpk.matvec_v1_p(packed, mean, invsd, v))
    assert torch.equal(tpk.crossprod_p(packed, mean, invsd, x[:, 5:6]),
                       z[:, 5:6])
    tpk.reset_launch_counts()
    g = tpk.gram_matvec_p(packed, mean, invsd, x[:, :1])
    assert tpk.launch_counts["crossprod_narrow"] == 1
    assert tpk.launch_counts["matvec_narrow"] == 1
    assert torch.equal(g, tpk.matvec_v1_p(packed, mean, invsd,
                                          tpk.crossprod_v1_p(
                                              packed, mean, invsd,
                                              x[:, :1])))


def _padded_launches(monkeypatch):
    """Route one-column chunks to B1 and B2 at kc 8 on the padded column,
    the path before the one-column kernels."""
    monkeypatch.setattr(tpk, "_launches",
                        lambda k, narrow=True: tpk._widths(k))


@pytest.mark.cuda
def test_solo_scca_on_card_bit_equal_to_padded_path(cuda, tmp_path,
                                                    monkeypatch):
    """A solo float32 scca() on the card (the device engine: every
    product a one-column chunk) through the one-column kernels gives the
    fit that B1 and B2 at kc 8 on the padded columns give: U, V, d and
    the iterations equal."""
    from flashpca_tpu_torch import scca

    ds = _card_fileset(tmp_path, 1003, 611, 12)
    rng = np.random.default_rng(13)
    Y = rng.standard_normal((1003, 5))
    kw = dict(ndim=3, maxiter=200, tol=1e-5, V0=rng.normal(size=(5, 3)),
              device=cuda)
    tpk.reset_launch_counts()
    got = scca(ds, Y, 2e-3, 1e-3, **kw)
    narrow = (tpk.launch_counts["crossprod_narrow"],
              tpk.launch_counts["matvec_narrow"])
    assert min(narrow) > 0
    assert tpk.launch_counts["crossprod"] + tpk.launch_counts["matvec"] <= 2
    _padded_launches(monkeypatch)
    tpk.reset_launch_counts()
    want = scca(ds, Y, 2e-3, 1e-3, **kw)
    assert tpk.launch_counts["crossprod_narrow"] == 0
    assert tpk.launch_counts["crossprod"] >= narrow[0]
    for a, b in ((got.U, want.U), (got.V, want.V), (got.d, want.d),
                 (got.n_iters, want.n_iters)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["wide", "tall", "sharded"])
def test_pca_and_check_launch_no_narrow_kernel(cuda, tmp_path, mode):
    """pca(k=20) + check() run their panels at kc 16-32: neither
    one-column kernel launches, on the wide, tall and 2-shard operators."""
    from flashpca_tpu_torch import check, pca
    from flashpca_tpu_torch.parallel import sharded_operator, snp_mesh

    n, p = (2003, 300) if mode == "tall" else (803, 1450)
    ds = _card_fileset(tmp_path, n, p, 14)
    tpk.reset_launch_counts()
    if mode == "sharded":
        r = pca(sharded_operator(ds, snp_mesh(["cuda:0"] * 2)), 20)
    else:
        r = pca(ds, 20, device=cuda, operator_mode=mode)
    check(ds, r.vectors, r.values, device=cuda)
    assert tpk.launch_counts["crossprod"] > 0
    assert tpk.launch_counts["crossprod_narrow"] == 0
    assert tpk.launch_counts["matvec_narrow"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 24, 28, 32, 40])
@pytest.mark.parametrize("n", [1001, 771, 4096])
@pytest.mark.parametrize("p", [133, 333])
def test_b4_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """B4 (matvec_ff_v2.cu) gives its first design's (y_hi, y_err) bit
    for bit at every KC (k 3 -> 8; 16; 24; 28 -> 32; 32; 40 -> 32 + 8):
    each output takes the same three FMA sequences and the same TwoSum
    fold every 64 SNP rows.  p = 133 = 2 x 64 + 5 and 333 = 5 x 64 + 13
    are ragged on the 64-row chunks; n = 1001 and 771 give 251 and 193
    bytes (nb % 16 != 0: rows staged byte by byte, a ragged last block),
    n = 4096 1,024.  Inputs from a seeded generator."""
    packed, _, _, nb = _operands(cuda, n, p)
    g = torch.Generator().manual_seed(13)
    lut6 = tpk.lut_rows(torch.randn((p, 4), generator=g),
                        torch.randn((p, 4), generator=g) * 1e-8).to(cuda)
    vh = torch.randn((p, k), generator=g).to(cuda)
    vl = (torch.randn((p, k), generator=g) * 1e-7).to(cuda)
    tpk.reset_launch_counts()
    yh, yl = tpk.matvec_ff_p(packed, lut6, vh, vl)
    fh, fl = tpk.matvec_ff_v1_p(packed, lut6, vh, vl)
    chunks = len(tpk._widths(k))
    assert tpk.launch_counts["matvec_ff"] == chunks
    assert tpk.launch_counts["matvec_ff_v1"] == chunks
    assert torch.equal(yh, fh) and torch.equal(yl, fl)
    ph, pl = tpk.matvec_ff_plain(packed.cpu(), lut6.cpu(), vh.cpu(),
                                 vl.cpu())
    _close(yh, ph)
    _close_pair(yh, yl, ph, pl)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 24, 28, 32])
@pytest.mark.parametrize("p,n", [(333, 1001), (133, 771), (333, 4096)])
def test_b3_is_bit_equal_to_its_first_design(cuda, k, p, n):
    """B3 (crossprod_ff_v2.cu) gives its first design's (z_hi, z_err) bit
    for bit at every KC (k 3 -> 8; 16; 24; 28 -> 32; 32): each output
    takes the same two FMA sequences and the same TwoSum fold every 32
    bytes.  p = 333 and 133 are ragged on B3's 128-row blocks; n = 1001
    and 771 give 251 and 193 bytes (nb % 16 != 0: a partial last chunk,
    rows staged byte by byte), n = 4096 1,024 (aligned)."""
    packed, _, _, nb = _operands(cuda, n, p)
    lut6 = tpk.lut_rows(torch.randn(p, 4, device=cuda),
                        torch.randn(p, 4, device=cuda) * 1e-8)
    x = torch.randn((4 * nb, k), device=cuda)
    tpk.reset_launch_counts()
    zh, zl = tpk.crossprod_ff_p(packed, lut6, x)
    vh, vl = tpk.crossprod_ff_v1_p(packed, lut6, x)
    assert tpk.launch_counts["crossprod_ff"] == 1
    assert tpk.launch_counts["crossprod_ff_v1"] == 1
    assert torch.equal(zh, vh) and torch.equal(zl, vl)
    ph, pl = tpk.crossprod_ff_plain(packed.cpu(), lut6.cpu(), x.cpu())
    _close(zh, ph)
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


def _card_fileset(tmp_path, n, p, seed):
    """A PLINK fileset of four populations, 1% missing calls."""
    from flashpca_tpu_torch import PlinkDataset
    from flashpca_tpu_torch.io.plink import write_bed

    rng = np.random.default_rng(seed)
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0, 0.15, (p, 4)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, np.arange(n) % 4].T).astype(float)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / f"f{seed}")
    write_bed(root, geno)
    return PlinkDataset.open(root)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, n, p, stream", [
    ("wide", 803, 450, {}),
    ("tall", 2003, 300, {}),
    ("wide", 803, 450, {"streaming": True, "block_size": 64}),
], ids=["wide", "tall", "wide-streamed"])
def test_float64_on_card_matches_cpu(cuda, tmp_path, mode, n, p, stream):
    """float64 on the card runs the functional core (no kernel launch):
    the same n_ops and n_restarts as the CPU float64 path on the same
    fileset, eigenvalues within 1e-10 relative, and check() mse equal
    to 2 significant digits (within 5e-3 relative)."""
    from flashpca_tpu_torch import check, pca

    ds = _card_fileset(tmp_path, n, p, 7)
    f64 = torch.float64
    tpk.reset_launch_counts()
    g = pca(ds, 5, device=cuda, dtype=f64, operator_mode=mode, **stream)
    cg = check(ds, g.vectors, g.values, device=cuda, dtype=f64, **stream)
    assert set(tpk.launch_counts.values()) == {0}
    c = pca(ds, 5, device="cpu", operator_mode=mode)
    cc = check(ds, c.vectors, c.values, device="cpu")
    assert (g.n_ops, g.n_restarts) == (c.n_ops, c.n_restarts)
    np.testing.assert_allclose(g.values, c.values, rtol=1e-10)
    assert abs(cg.mse - cc.mse) <= 5e-3 * cc.mse


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [{}, {"streaming": True,
                                         "block_size": 64}],
                         ids=["resident", "streamed"])
def test_project_and_ucca_on_card_match_cpu(cuda, tmp_path, stream):
    """project() and ucca() on the card against the CPU float64 path on
    the same fileset: at float32 through B2 (project) and B1 (ucca),
    project within 1e-5 relative in each column's norm, ucca's R and F
    within rtol 1e-5 and -log10 P within 1e-4; at float64 through the
    functional core (no launch) within rtol 1e-10 (the projection's
    near-zero entries within 1e-10 of its largest).  Streamed in blocks
    of 64 SNPs, ucca at float32 equals the resident result bit for bit
    (B1's rows do not depend on the blocking)."""
    from flashpca_tpu_torch import project, ucca
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    ds = _card_fileset(tmp_path, 803, 450, 8)
    rng = np.random.default_rng(9)
    V = rng.standard_normal((450, 4))
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    Y = rng.standard_normal((803, 3)) + 0.3 * X[:, [5, 50, 400]]
    want_p = project(ds, V, device="cpu").projection
    want_u = ucca(ds, Y, device="cpu").result

    tpk.reset_launch_counts()
    got_p = project(ds, V, device=cuda, **stream).projection
    assert tpk.launch_counts["matvec"] > 0
    err = (np.linalg.norm(got_p - want_p, axis=0)
           / np.linalg.norm(want_p, axis=0))
    assert err.max() < 1e-5
    tpk.reset_launch_counts()
    got_u = ucca(ds, Y, device=cuda, **stream).result
    assert tpk.launch_counts["crossprod"] > 0
    np.testing.assert_allclose(got_u[:, :2], want_u[:, :2], rtol=1e-5)
    np.testing.assert_allclose(-np.log10(got_u[:, 2]),
                               -np.log10(want_u[:, 2]), atol=1e-4)
    if stream:
        assert np.array_equal(got_u, ucca(ds, Y, device=cuda).result)

    tpk.reset_launch_counts()
    p64 = project(ds, V, device=cuda, dtype=torch.float64, **stream)
    u64 = ucca(ds, Y, device=cuda, dtype=torch.float64, **stream)
    assert set(tpk.launch_counts.values()) == {0}
    np.testing.assert_allclose(p64.projection, want_p, rtol=1e-10,
                               atol=1e-10 * np.abs(want_p).max())
    np.testing.assert_allclose(u64.result, want_u, rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [{}, {"streaming": True,
                                         "block_size": 64}],
                         ids=["resident", "streamed"])
def test_scca_and_grid_on_card_match_cpu(cuda, tmp_path, stream):
    """scca() and a 2 x 2 scca_grid() on the card against the CPU
    float64 path on the same fileset (the device engine resident, the
    host engines streamed).  At float64 (the functional core, no launch)
    d within rtol 1e-10, U and V within 1e-10, the grid's iterations
    equal; at float32 (tol 1e-5) through B1 and B2, both launched, d
    within rtol 1e-5 and U, V within 2e-4 of the float64 result (tol 1e-5
    stops each fit within about 1e-5 of its fixed point)."""
    from flashpca_tpu_torch import scca, scca_grid
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    ds = _card_fileset(tmp_path, 803, 450, 10)
    rng = np.random.default_rng(11)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    Y = rng.standard_normal((803, 4)) + 0.3 * X[:, [5, 50, 400, 7]]
    kw = dict(ndim=2, maxiter=1000, V0=rng.normal(size=(4, 2)))
    lam, l1, l2 = (2e-3, 1e-3), [1e-3, 2e-3], [1e-3, 5e-3]
    want = scca(ds, Y, *lam, device="cpu", tol=1e-6, **kw)
    want_g = scca_grid(ds, Y, l1, l2, device="cpu", tol=1e-6, **kw)
    assert want.converged and want_g.converged.all()

    tpk.reset_launch_counts()
    f64 = dict(device=cuda, dtype=torch.float64, tol=1e-6, **stream, **kw)
    got = scca(ds, Y, *lam, **f64)
    got_g = scca_grid(ds, Y, l1, l2, **f64)
    assert set(tpk.launch_counts.values()) == {0}
    np.testing.assert_allclose(got.d, want.d, rtol=1e-10)
    np.testing.assert_array_equal(got_g.n_iters, want_g.n_iters)
    for a, b in ((got.U, want.U), (got.V, want.V), (got_g.U, want_g.U),
                 (got_g.V, want_g.V), (got_g.d, want_g.d)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)

    tpk.reset_launch_counts()
    f32 = dict(device=cuda, tol=1e-5, **stream, **kw)
    got = scca(ds, Y, *lam, **f32)
    got_g = scca_grid(ds, Y, l1, l2, **f32)
    assert tpk.launch_counts["crossprod"] > 0
    assert tpk.launch_counts["matvec"] > 0
    assert got.converged and got_g.converged.all()
    np.testing.assert_allclose(got.d, want.d, rtol=1e-5)
    np.testing.assert_allclose(got_g.d, want_g.d, rtol=1e-5)
    for a, b in ((got.U, want.U), (got.V, want.V), (got_g.U, want_g.U),
                 (got_g.V, want_g.V)):
        np.testing.assert_allclose(a, b, atol=2e-4)


def _same_search(got, want, corr_atol, nz_share):
    """Two penalty searches (cv_scca or split_scca) on one grid: the
    converged flags equal, the correlations within ``corr_atol`` where
    finite (finite in the same cells), the non-zero counts of the cells
    that converged throughout within ``nz_share`` of ``want``'s."""
    np.testing.assert_array_equal(got.converged, want.converged)
    keys = (("corr_test", "corr_train") if hasattr(want, "corr_test")
            else ("corr",))
    for key in keys:
        a, b = getattr(got, key), getattr(want, key)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                                   rtol=0, atol=corr_atol)
    conv = (want.converged if want.converged.ndim == 2
            else want.converged.all(axis=0))
    for a, b in ((got.nzero_x, want.nzero_x), (got.nzero_y, want.nzero_y)):
        assert (np.abs(a - b)[:, conv] <= nz_share * b[:, conv]).all()


@pytest.mark.cuda
def test_cv_and_split_on_card_match_cpu(cuda, tmp_path):
    """cv_scca (3 folds, init=True) and split_scca on a 2 x 2 grid, on a
    fileset of 803 samples (n % 4 = 3: the folds' and splits' last
    bytes are padding), on the card against the CPU float64 path: at
    float64 (the functional core, no launch) correlations within 1e-9
    and the non-zero counts equal; at float32 through B1 and B2 (both
    launched, tol 1e-5) correlations within 1e-4 and non-zeros within 2%
    (chip_smoke's CV_CORR_BAR and CV_NZ_SHARE); folds and splits equal,
    and the best cell the same."""
    from flashpca_tpu_torch import cv_scca, split_scca
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    ds = _card_fileset(tmp_path, 803, 450, 12)
    rng = np.random.default_rng(13)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    Y = rng.standard_normal((803, 4)) + 0.3 * X[:, [5, 50, 400, 7]]
    l1, l2 = [1e-3, 2e-2], [1e-3, 5e-2]
    kw = dict(ndim=2, maxiter=1000, tol=1e-5)
    runs = {"cv": (cv_scca, dict(nfolds=3, init=True)),
            "split": (split_scca, dict(prop_train=0.7))}
    for name, (fn, extra) in runs.items():
        want = fn(ds, Y, l1, l2, device="cpu", **kw, **extra)
        tpk.reset_launch_counts()
        got64 = fn(ds, Y, l1, l2, device=cuda, dtype=torch.float64, **kw,
                   **extra)
        assert set(tpk.launch_counts.values()) == {0}, name
        _same_search(got64, want, 1e-9, 0.0)
        tpk.reset_launch_counts()
        got = fn(ds, Y, l1, l2, device=cuda, **kw, **extra)
        assert tpk.launch_counts["crossprod"] > 0, name
        assert tpk.launch_counts["matvec"] > 0, name
        _same_search(got, want, 1e-4, 0.02)
        assert (got.best_lambda1, got.best_lambda2) == (
            want.best_lambda1, want.best_lambda2)
        if name == "cv":
            np.testing.assert_array_equal(got.folds, want.folds)
        else:
            np.testing.assert_array_equal(got.train_idx, want.train_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 24, 40])
@pytest.mark.parametrize("n", [1001, 1024])
def test_sweep_kernels_match_plain(cuda, k, n):
    """The kernel sweep's V1-V4 against their plain versions at the
    bars above (V3's three products at sqrt(3) x the atol; its
    tensor-core sums are not IEEE add sequences), and each launching
    once per column chunk; B1's tile entries bit-equal to production B1,
    B2's against its plain version."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv

    packed, mean, invsd, nb = _operands(cuda, n, 333)
    p = packed.shape[0]
    x = torch.randn((4 * nb, k), device=cuda)
    v = torch.randn((p, k), device=cuda)
    cpu = (packed.cpu(), mean.cpu(), invsd.cpu())
    chunks = len(tpk._widths(k))
    for name, (wrapper, plain) in cv.VARIANTS.items():
        tpk.reset_launch_counts()
        got = wrapper(packed, mean, invsd, x)
        assert tpk.launch_counts[name] == chunks
        atol = 2e-4 * (3 ** 0.5 if name == "crossprod_split3" else 1.0)
        _close(got, plain(*cpu, x.cpu()), atol=atol)
    z = tpk.crossprod_p(packed, mean, invsd, x)
    for tm in cv.TILE_TM:
        assert torch.equal(cv.crossprod_tiled_p(packed, mean, invsd, x, tm), z)
    for cr in cv.TILE_CR:
        _close(cv.matvec_tiled_p(packed, mean, invsd, v, cr),
               tpk.matvec_p(*cpu, v.cpu()))


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,block_snps", [(1024, 4096, 100),
                                            (333, 1001, 40)],
                         ids=["aligned", "nb%16!=0"])
def test_streamed_products_bit_equal_to_same_order(cuda, p, n, block_snps):
    """chip_smoke.py's streamed phase at two small shapes (the second
    with nb = 251 bytes, not a multiple of 16): in each staging
    configuration three back-to-back products of each kind, no
    synchronisation between them, torch.equal to the same blocks'
    products summed in the same order from the resident tensor's row
    slices, and crossprod to B1 on the whole tensor."""
    cs = _chip_smoke()
    out = cs.check_streamed(cuda, ((f"{p} x {n}", p, n, 31,
                                    {"block_snps": block_snps}),))
    assert len(out) == len(cs.STREAM_CONFIGS)
    assert all(r["n_blocks"] >= 9 for r in out.values())


@pytest.mark.cuda
def test_streaming_block_cache_on_the_card(cuda):
    """cache_mb="auto" keeps every block of a small cohort on the card
    after its first staging (half the card's memory, torch.cuda
    .mem_get_info); memory_mb turns it off."""
    from flashpca_tpu_torch import StreamingPackedOperator
    from flashpca_tpu_torch.ops.genotypes import permute_samples

    cs = _chip_smoke()
    n, p = 1001, 333
    packed, mean, sd, _ = cs.card_data(cuda, n, p, 32)
    host = packed.cpu().numpy()
    auto = StreamingPackedOperator(host, mean, sd, n, block_snps=40,
                                   device=cuda)
    bounded = StreamingPackedOperator(host, mean, sd, n, memory_mb=1,
                                      block_snps=40, device=cuda)
    assert auto.stats()["n_cached"] == auto.n_blocks == 9
    assert bounded.stats()["n_cached"] == 0
    x = torch.randn((n, 8), device=cuda)
    ys = [auto.perform_op(x) for _ in range(3)]
    assert auto.staged_host_blocks == auto.n_blocks
    assert auto.stats()["device_bytes"] == packed.numel()
    yb = bounded.perform_op(x)
    for y in ys:
        assert torch.equal(y, yb)
    xp = permute_samples(x, auto.nbytes)
    assert torch.equal(auto.gram_permuted(xp), bounded.gram_permuted(xp))
    assert bounded.stats()["device_bytes"] == 2 * 40 * auto.nbytes


@pytest.mark.cuda
def test_streamed_pca_matches_resident(cuda, tmp_path):
    """pca(streaming=True, memory_mb=1) and check() on an 8,001 x 4,096
    fileset streamed from its .bed memmap, through B1-B4 per block: the
    eigenvalues within 2e-6 relative of the resident run, check mse <
    1e-8."""
    from flashpca_tpu_torch import PlinkDataset, check, pca
    from flashpca_tpu_torch.io.plink import write_bed

    rng = np.random.default_rng(5)
    n, p, pops = 8001, 4096, 12
    w = 0.8 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.1, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    root = str(tmp_path / "mid")
    write_bed(root, geno)
    del geno
    ds = PlinkDataset.open(root)
    res = pca(ds, 10, device=cuda)
    tpk.reset_launch_counts()
    res_s = pca(ds, 10, device=cuda, streaming=True, memory_mb=1)
    chk_s = check(ds, res_s.vectors, res_s.values, device=cuda,
                  streaming=True, memory_mb=1)
    assert all(tpk.launch_counts[k] > 0 for k in
               ("crossprod", "matvec", "crossprod_ff", "matvec_ff"))
    assert np.all(np.abs(res_s.values - res.values) <= 2e-6 * res.values)
    assert chk_s.mse < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,block_bytes", [(1024, 4096, 128),
                                             (333, 1001, 60)],
                         ids=["aligned", "ragged"])
def test_tall_streamed_products_bit_equal_to_same_order(cuda, tmp_path, p,
                                                        n, block_bytes):
    """chip_smoke.py's tall same-order phase at two block sizes (the
    second with n % 4 == 1 and a last block of 11 bytes): in each staging
    configuration the plain gram, the two-float gram and prod at kc 16
    and 32, back to back, torch.equal to the same blocks' kernel calls
    summed in block order."""
    cs = _chip_smoke()
    out = cs.check_tall_streamed(cuda, str(tmp_path), (
        (f"{p} x {n}", p, n, 33, {"block_bytes": block_bytes}, False),))
    assert len(out) == len(cs.STREAM_CONFIGS)
    assert all(r["n_blocks"] >= 5 for r in out.values())


@pytest.mark.cuda
def test_tall_streamed_pca_matches_resident(cuda):
    """pca() on a 40,003 x 1,024 cohort generated on the card, streamed in
    eleven blocks of 1,000 bytes through B2, B1, B5 and B3 per block,
    against the resident tall operator on the same bytes: the same
    n_ops, eigenvalues within 2e-6 of the largest."""
    from flashpca_tpu_torch import (TallPackedOperator,
                                    TallStreamingOperator, pca)

    cs = _chip_smoke()
    n, p = 40_003, 1024
    packed, mean, sd, sumsq = cs.card_data(cuda, n, p, 34)
    res = pca(TallPackedOperator(packed, mean, sd, n, device=cuda,
                                 snp_sumsq=sumsq), 10)
    op = TallStreamingOperator(packed.cpu().numpy(), mean, sd, n,
                               block_bytes=1000, cache_mb=0, device=cuda,
                               snp_sumsq=sumsq)
    assert op.n_blocks == 11
    tpk.reset_launch_counts()
    res_s = pca(op, 10)
    assert all(tpk.launch_counts[k] > 0 for k in
               ("crossprod", "matvec", "crossprod_ff", "matvec_ff_novl"))
    assert res_s.n_ops == res.n_ops
    assert np.all(np.abs(res_s.values - res.values)
                  <= 2e-6 * res.values[0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16])
def test_tall_streamed_crossprod_on_card_matches_cpu(cuda, k):
    """TallStreamingOperator.crossprod (B1 on each of eleven blocks of
    1,000 bytes, the last ragged) on the card against the CPU operator
    on the same bytes through the kernels' plain versions, both at
    float32: each column within 1e-5 of its largest |z|; one B1 launch
    a block (a vector's through B1's one-column kernel)."""
    from flashpca_tpu_torch import TallStreamingOperator

    cs = _chip_smoke()
    n, p = 40_003, 1024
    packed, mean, sd, _ = cs.card_data(cuda, n, p, 36)
    host = packed.cpu().numpy()
    kw = dict(block_bytes=1000, cache_mb=0, dtype=torch.float32,
              use_kernels=True)
    op = TallStreamingOperator(host, mean, sd, n, device=cuda, **kw)
    ref = TallStreamingOperator(host, mean, sd, n, device="cpu", **kw)
    assert op.n_blocks == 11
    x = torch.randn((n, k), generator=torch.Generator().manual_seed(k))
    x = x[:, 0] if k == 1 else x
    tpk.reset_launch_counts()
    z = op.crossprod(x.to(cuda))
    b1 = "crossprod_narrow" if k == 1 else "crossprod"
    assert tpk.launch_counts[b1] == op.n_blocks
    assert sum(tpk.launch_counts.values()) == op.n_blocks
    want = ref.crossprod(x).double().reshape(p, k)
    err = (z.cpu().double().reshape(p, k) - want).abs().amax(0)
    assert float((err / want.abs().amax(0)).max()) < 1e-5


@pytest.mark.cuda
def test_tall_stream_device_bytes_within_memory_mb(cuda):
    """memory_mb bounds the packed bytes the tall streaming operator
    holds on the card: its two block buffers, and no cache."""
    from flashpca_tpu_torch import TallStreamingOperator

    cs = _chip_smoke()
    n, p = 40_003, 1024
    packed, mean, sd, _ = cs.card_data(cuda, n, p, 35)
    op = TallStreamingOperator(packed.cpu().numpy(), mean, sd, n,
                               memory_mb=1, device=cuda)
    assert op.block_bytes == 512 and op.n_blocks == 20
    v = torch.randn((p, 16), device=cuda)
    op.gram_permuted(v)
    op.gram_ff_permuted(v)
    st = op.stats()
    assert st["n_cached"] == 0
    assert st["device_bytes"] == 2 * p * 512 <= 1 << 20


def _dense_geno(n, p, seed, pops=6):
    rng = np.random.default_rng(seed)
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0, 0.15, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, np.arange(n) % pops].T).astype(float)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    return geno


@pytest.mark.cuda
def test_dense_pca_on_card_matches_cpu_float64(cuda):
    """pca() on a numeric matrix at float32 on the card (the dense
    operator's torch.matmul products in full float32, TF32 off, no
    kernel launched; n % 2048 != 0, a ragged two-float chunk) against
    the CPU float64 path on six populations' five PCs: eigenvalues
    within 1e-6 of the largest (float32 Ritz values carry ~1e-7 of
    ||A||, as chip_smoke.py's mid-size bar), |cos| > 1 - 1e-6,
    check mse < 1e-8 on the matrix (a float64 DenseOperator on the
    card) and through a float32 DenseOperator on the card; ucca on that
    operator within rtol 1e-5 (R, F) and 1e-4 (-log10 P) of the CPU
    float64 matrix path, and the matrix path on the card (float64)
    within rtol 1e-10 of the CPU's."""
    from flashpca_tpu_torch import DenseOperator, check, pca, ucca
    from flashpca_tpu_torch.ops.standardize import standardize

    n, p = 2100, 700
    geno = _dense_geno(n, p, 12)
    tpk.reset_launch_counts()
    r32 = pca(geno, 5, device=cuda)
    X_std, mean, sd = standardize(geno, "binom2")
    op = DenseOperator(X_std, center=mean, scale=sd, device=cuda)
    assert op.dtype == torch.float32
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    r64 = pca(geno, 5, device="cpu")
    assert np.all(np.abs(r32.values - r64.values) <= 1e-6 * r64.values[0])
    dots = np.abs(np.sum(r32.vectors * r64.vectors, axis=0))
    assert np.all(dots > 1 - 1e-6)
    assert check(geno, r32.vectors, r32.values).mse < 1e-8
    assert check(op, r32.vectors, r32.values).mse < 1e-8
    Y = np.random.default_rng(13).standard_normal((n, 3))
    got, want = ucca(op, Y).result, ucca(geno, Y, device="cpu").result
    np.testing.assert_allclose(ucca(geno, Y).result, want, rtol=1e-10)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-5)
    np.testing.assert_allclose(-np.log10(got[:, 2]), -np.log10(want[:, 2]),
                               atol=1e-4)
    assert set(tpk.launch_counts.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("n, p, k", [(10_001, 3_000, 24), (4_097, 2_049, 48)])
def test_dense_gram_ff_extra_peak_memory_on_card(cuda, n, p, k):
    """The ragged two-float dense gram copies no part of X: its extra
    peak device memory stays within a quarter of X's bytes, and hi + lo
    is within 1e-6 of each column's largest entry of the float64
    product of the same float32 X."""
    from flashpca_tpu_torch.ops.compensated import dense_gram_ff

    g = torch.Generator(device=cuda).manual_seed(n)
    X = torch.randn((n, p), device=cuda, generator=g)
    x = torch.randn((n, k), device=cuda, generator=g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hi, lo = dense_gram_ff(X, x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 0.25 * X.numel() * X.element_size()
    X64 = X.double()
    exact = X64 @ (X64.T @ x.double())
    err = (hi.double() + lo.double() - exact).abs().amax(dim=0)
    assert bool((err <= 1e-6 * exact.abs().amax(dim=0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tall", [False, True], ids=["wide", "tall"])
def test_two_shard_operator_on_card_matches_one_shard(cuda, tmp_path, tall):
    """A 2-shard mesh on cuda:0 (SNP rows, or byte columns on the tall
    path) against the one-shard operator on the same bytes: float64 at
    rtol 1e-10, atol 1e-8 (the same products summed in another order:
    entries that cancel out of ~1e3-sized terms carry ~1e-11 absolute),
    float32 within
    the kernels' bars, two-float pairs at 5e-6 -- float32 through the
    kernels, float64 through none."""
    from flashpca_tpu_torch.io.plink import write_bed
    from flashpca_tpu_torch.parallel import (sharded_operator, snp_mesh,
                                             tall_sharded_operator)

    rng = np.random.default_rng(19)
    n, p = 3003, 1201
    geno = rng.binomial(2, rng.uniform(0.05, 0.5, p)[None, :],
                        size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.02] = np.nan
    root = str(tmp_path / "shards")
    write_bed(root, geno)
    build = tall_sharded_operator if tall else sharded_operator
    axis = "samples" if tall else "snps"
    x = torch.randn((n, 20), device=cuda, dtype=torch.float64)
    v = torch.randn((p, 20), device=cuda, dtype=torch.float64)
    for dt in (torch.float64, torch.float32):
        one = build(root, snp_mesh(["cuda:0"], axis_name=axis), dtype=dt)
        tpk.reset_launch_counts()
        two = build(root, snp_mesh(["cuda:0"] * 2, axis_name=axis),
                    dtype=dt)
        f64 = dt == torch.float64
        bar = dict(rtol=1e-10, atol=1e-8) if f64 else {}
        if tall:
            vv = v.to(dt)
            _close(two.gram_permuted(vv), one.gram_permuted(vv),
                   **(bar or dict(rtol=2e-4, atol=2e-3)))
            _close(two.prod(vv), one.prod(vv), **bar)
            if not f64:
                _close_pair(*two.gram_ff_permuted(vv),
                            *one.gram_ff_permuted(vv))
        else:
            xx = x.to(dt)
            _close(two.perform_op(xx), one.perform_op(xx),
                   **(bar or dict(rtol=2e-4, atol=2e-3)))
            _close(two.crossprod(xx), one.crossprod(xx), **bar)
            _close(two.prod(v.to(dt)), one.prod(v.to(dt)), **bar)
            _close_pair(*two.perform_op_ff(xx), *one.perform_op_ff(xx))
        launched = {k for k, c in tpk.launch_counts.items() if c}
        if f64:
            assert not launched          # float64 runs the functional core
        else:
            assert {"crossprod", "matvec"} <= launched


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100352, 501760], ids=["tall", "wide"])
def test_start_basis_on_card_matches_host_qr(cuda, n):
    """The solver's start panel factored on the card at the benchmark's
    panel heights: numpy's QR of the same seeded draw to 1e-12 column
    for column, orthonormal to 1e-13 in float64.  Prints the whole
    start's time (draw, upload, QR, cast) and the device QR's alone
    (median of 5, after a warm-up)."""
    import time

    from flashpca_tpu_torch.solvers import block_lanczos as tbl

    b, seed = 16, 3
    tbl._start_basis(n, 2 * b, b, seed, None, torch.float32, cuda)
    torch.cuda.synchronize()
    whole, qr = [], []
    for _ in range(5):
        t = time.perf_counter()
        V = tbl._start_basis(n, 2 * b, b, seed, None, torch.float64, cuda)
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t)
        Q0 = torch.as_tensor(
            np.random.default_rng(seed).standard_normal((n, b)), device=cuda)
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.linalg.qr(Q0)
        torch.cuda.synchronize()
        qr.append(time.perf_counter() - t)
    print(f"\nstart basis {n} x {b}: whole {np.median(whole) * 1e3:.3f} ms, "
          f"device QR {np.median(qr) * 1e3:.3f} ms "
          f"({torch.cuda.get_device_name()})")
    want, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, b)))
    got = V[:, :b].cpu().numpy()
    assert np.abs(got - want).max() <= 1e-12
    assert np.abs(got.T @ got - np.eye(b)).max() <= 1e-13
    assert not bool(V[:, b:].any())


@pytest.mark.cuda
def test_sharded_gram_runs_its_cards_at_once(cuda):
    """A one-process mesh over every card present (2 to 4), 50,176
    samples x 100,352 SNPs a card: a kc-16 gram's wall time, synchronised,
    is at most 0.6 x the sum of its shards' grams run alone, each on its
    card, and its result is the serial shard-order sum's bit for bit.
    Prints the times (median of 5, after a warm-up)."""
    import time

    from flashpca_tpu_torch import PackedOperator
    from flashpca_tpu_torch.parallel import Mesh

    S = min(4, torch.cuda.device_count())
    if S < 2:
        pytest.skip("needs two or more CUDA cards")
    n, rows = 50_176, 100_352
    devs = [torch.device(f"cuda:{i}") for i in range(S)]
    rng = np.random.default_rng(23)
    mean = rng.uniform(0.1, 1.9, S * rows)
    sd = rng.uniform(0.3, 1.0, S * rows)
    shards = [torch.randint(0, 256, (rows, n // 4), dtype=torch.uint8,
                            device=d, generator=torch.Generator(
                                device=d).manual_seed(s))
              for s, d in enumerate(devs)]
    op = PackedOperator(shards, mean, sd, n, mesh=Mesh(devs),
                        n_snps=S * rows)
    alone = [PackedOperator(shards[s], mean[s * rows: (s + 1) * rows],
                            sd[s * rows: (s + 1) * rows], n, device=d)
             for s, d in enumerate(devs)]
    xp = torch.randn((op.n4, 16), device=cuda)
    xs = [xp.to(d) for d in devs]

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    def timed(fn):
        fn()
        sync()
        out = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            sync()
            out.append(time.perf_counter() - t)
        return float(np.median(out))

    wall = timed(lambda: op._gram_raw(xp))
    each = [timed(lambda s=s: alone[s]._gram_raw(xs[s])) for s in range(S)]
    print(f"\n{S} cards ({torch.cuda.get_device_name()}): sharded gram "
          f"{wall * 1e3:.3f} ms, shards alone "
          f"{', '.join(f'{t * 1e3:.3f}' for t in each)} ms")
    assert wall <= 0.6 * sum(each)
    want = None
    for (blk, lo, hi), d in zip(op._shards, devs):
        t = tpk.gram_matvec_p(blk, op.mean[lo:hi].to(d),
                              op.invsd[lo:hi].to(d), xp.to(d)).to(cuda)
        want = t if want is None else want + t
    assert torch.equal(op._gram_raw(xp), want)
