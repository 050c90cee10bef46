#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashpca_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, all in this one process; any failure raises and exits nonzero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels B1-B5 from kernels/csrc (timed set-up);
3. hold each kernel against its plain PyTorch version on the card, at
   full width (501,760 samples) on a 4,096-SNP slice and on a small odd
   case (n % 4 != 0, some inv_sd == 0), panels k in {3, 16, 24}, and
   each against a float64 product.  B5 and the tall two-float gram (B5,
   mask, B3, B1) likewise on those cases and at the tall width (2,048
   SNPs x 1,003,520 samples), panels k in {3, 16, 28}, and there B1-B3
   at k in {16, 28}; the gram within 1.5e-7 of float64, which the plain
   float32 gram (B2, mask, B1) must miss at the tall width;
4. a mid-size PLINK fileset (8,001 x 4,096, written by the port's
   write_bed) through ``pca(root, 10)`` and ``check()``, against a
   float64 dense eigendecomposition;
5. the wide headline: structured genotypes 501,760 x 100,352 generated
   on the card (12.6 GB packed, never decoded whole), ``pca(op, 20)``
   with ``polish="contract"`` at float32, then ``check(op, U, d)``; the
   kernels' launch counts are reset just before ``pca`` and read just
   after ``check``, and every kernel of the wide path (B1-B4) must have
   run; then B1-B4 timed at the headline shapes beside their bounds,
   their plain versions and the torch.matmul calls on the same block
   decoded to float32;
6. the tall headline: 1,003,520 x 50,176 generated the same way, held
   by a ``TallPackedOperator``; ``pca(op, 20)`` with
   ``polish="contract"`` at float32 on the tall path (counts reset just
   before, read just after: B1, B2, B3 and B5 must have run), then the
   wide path's ``pca`` on the same bytes and ``check()`` of both results
   through the wide operator: the tall check mse must stay within
   max(1e-8, 2 x the wide one); each eigenvalue of the two paths within
   2e-6 of the largest of each other and of a float64 eigendecomposition
   of X^T X / p formed on the card (p x p float64, 20 GB, ~100 s), save
   that in the Marchenko-Pastur bulk the bar below is 3.6e-5 (and
   between the paths 3.6e-5 both ways); then B5 (and B1-B3 at their
   tall widths) timed at the tall shapes.

The line before the last is the JSON ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Hopper FP32 (CUDA-core) peak and memory rate of an H100 SXM, the
# published dense figures at the 700 W limit.  Full-float32 products do
# not use the tensor cores (TF32 would lose the check contract), so the
# FP32 rate bounds the kernels' operations.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
EPS32 = 2.0 ** -24          # float32 unit roundoff
# relative float64 bar of the tall two-float gram: its readings at the
# check cases are 2.8-8.7e-8, and the plain float32 gram's are higher
GRAM_F64_BAR = 1.5e-7
# eigenvalue bars of the tall headline, in units of the largest: the
# population pairs to 2e-6; the Marchenko-Pastur bulk pairs, which
# both float32 paths leave up to 1.21e-5 below the float64 ones, to 3x
# that below (one-sided: above them 2e-6 still holds)
EIG_BAR, BULK_BAR = 2e-6, 3.6e-5

TPU_KERNEL = {
    "crossprod": "flashpca_tpu/kernels/packed_matvec.py:83",
    "matvec": "flashpca_tpu/kernels/packed_matvec.py:122",
    "crossprod_ff": "flashpca_tpu/kernels/packed_matvec.py:336",
    "matvec_ff": "flashpca_tpu/kernels/packed_matvec.py:369",
    "matvec_ff_novl": "flashpca_tpu/kernels/packed_matvec.py:415",
}
_CSRC = "flashpca_tpu_torch/kernels/csrc/"
SOURCE = {"crossprod": _CSRC + "crossprod.cu", "matvec": _CSRC + "matvec.cu",
          "crossprod_ff": _CSRC + "crossprod_ff.cu",
          "matvec_ff": _CSRC + "matvec_ff.cu",
          "matvec_ff_novl": _CSRC + "matvec_ff.cu"}
# float32 dots per genotype and panel column
DOTS = {"crossprod": 1, "matvec": 1, "crossprod_ff": 2, "matvec_ff": 3,
        "matvec_ff_novl": 2}
# the kernels each main path must launch
WIDE_PATH = ("crossprod", "matvec", "crossprod_ff", "matvec_ff")
TALL_PATH = ("crossprod", "matvec", "crossprod_ff", "matvec_ff_novl")
# kernel-check shapes (label, SNPs, samples, seed): a full-width slice of
# the headline and a small odd case (n % 4 != 0); the tall kernels also
# run at the tall headline's width
KERNEL_CASES = (("full width 4096 x 501760", 4096, 501_760, 21),
                ("odd 333 x 1001", 333, 1001, 22))
TALL_CASE = ("tall width 2048 x 1003520", 2048, 1_003_520, 23)
# the tall headline: the JAX package's tall bench shape (bench.py)
TALL_N, TALL_P = 1_003_520, 50_176


def say(msg: str) -> None:
    print(msg, flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        sync()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            sync()
            self.seconds = time.time() - self.t0
            say(f"   {self.name}: {self.seconds:.2f} s")


def close(name, got, want, rtol, atol):
    """Assert |got - want| <= atol + rtol |want| elementwise (``atol`` a
    number or a tensor of per-entry bounds); return the max absolute
    error."""
    g = got.double()
    w = want.double()
    err = (g - w).abs()
    bar = atol + rtol * w.abs()
    bad = err > bar
    if not bool(g.isfinite().all()) or bool(bad.any()):
        i = int((err - bar).argmax())
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries off "
            f"(max abs err {float(err.max()):.3e}, rtol {rtol}; worst "
            f"entry off by {float(err.flatten()[i]):.3e} against its bar "
            f"{float(bar.flatten()[i]):.3e})")
    return float(err.max())


def rel_err(got, ref):
    return float((got - ref).norm() / ref.norm())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_operands(p, n, seed, dev):
    """Random packed bytes (every code, missing included), per-SNP stats
    with a few inv_sd == 0 rows, their exact two-float tables."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.compensated import code_value_luts
    from flashpca_tpu_torch.ops.standardize import lookup_tables

    rng = np.random.default_rng(seed)
    nb = (n + 3) // 4
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (p, nb), generator=g, dtype=torch.uint8,
                           device=dev)
    mean = rng.uniform(0.1, 1.9, p)
    sd = rng.uniform(0.4, 0.9, p)
    sd[-5:] = 0.0
    m32, i32 = lookup_tables(mean, sd, dtype=np.float32)
    luts = tuple(torch.as_tensor(t, device=dev)
                 for t in code_value_luts(mean, sd))
    return (packed, torch.as_tensor(m32, device=dev),
            torch.as_tensor(i32, device=dev), tpk.lut_rows(*luts), nb, luts)


def f64_product(packed, lut6, x, *, transpose, rows=512):
    """float64 W x (transpose=False, x (n4,k)) or W^T x (x (p,k)), W the
    exact two-float tables' sum, decoded in SNP-row chunks."""
    import torch

    from flashpca_tpu_torch.ops.compensated import decode_lut

    p = packed.shape[0]
    lut = [lut6[[0, 0, 1, 2]].T.double(), lut6[[3, 3, 4, 5]].T.double()]
    for t in lut:
        t[:, 1] = 0.0                       # code 1 (missing) decodes to 0
    x = x.double()
    out = (torch.zeros((packed.shape[1] * 4, x.shape[1]), dtype=torch.float64,
                       device=x.device) if transpose else [])
    for r0 in range(0, p, rows):
        blk = packed[r0: r0 + rows]
        W = (decode_lut(blk, lut[0][r0: r0 + rows], torch.float64)
             + decode_lut(blk, lut[1][r0: r0 + rows], torch.float64))
        if transpose:
            out += W.T @ x[r0: r0 + rows]
        else:
            out.append(W @ x)
    return out if transpose else torch.cat(out)


def plain_bar(length):
    """(rtol, atol) for two float32 accumulations of one ``length``-term
    contraction: the Pallas tests' bar for 512 terms (rtol 2e-5, atol
    2e-4), with atol grown like the rounding error of a float32 sum of
    random-sign terms, sqrt(length / 512) (about 31x at 501,760 terms)."""
    return 2e-5, 2e-4 * max(1.0, (length / 512) ** 0.5)


def hold(tag, got, plain, ref, bar, f64_bar, sums=False):
    """Hold a kernel result against its plain version under ``bar``
    (rtol, atol) -- two-float pairs by their hi halves, or with ``sums``
    by the pairs' float64 sums -- and both against the float64 product
    ``ref`` (pairs summed) within the relative ``f64_bar``.  Returns
    (max abs err vs plain, kernel's relative err vs float64)."""
    ff = isinstance(got, tuple)

    def f64(r):
        return r[0].double() + r[1].double() if ff else r.double()

    if ff and not sums:
        err = close(tag, got[0], plain[0], *bar)
    else:
        err = close(tag, f64(got), f64(plain), *bar)
    rels = []
    for who, r in (("kernel", got), ("plain", plain)):
        rels.append(rel_err(f64(r), ref))
        if not rels[-1] < f64_bar:
            raise AssertionError(f"{tag} {who}: vs float64 rel "
                                 f"{rels[-1]:.2e} (bar {f64_bar})")
    return err, rels[0]


def check_kernels(dev):
    """Each kernel against its plain version and against a float64
    product, on a full-width slice and a small odd case.  Returns
    {kernel: max abs err against the plain version}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    worst = {name: 0.0 for name in WIDE_PATH}
    for label, p, n, seed in KERNEL_CASES:
        packed, mean, invsd, lut6, nb, _ = random_operands(p, n, seed, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 100)
        for k in (3, 16, 24):
            x = torch.randn((4 * nb, k), generator=g, device=dev)
            v = torch.randn((p, k), generator=g, device=dev)
            vl = torch.randn((p, k), generator=g, device=dev) * 1e-7
            ref_z = f64_product(packed, lut6, x, transpose=False)
            ref_y = f64_product(packed, lut6, v, transpose=True)
            ref_yy = f64_product(packed, lut6, v.double() + vl.double(),
                                 transpose=True)
            bar_z, bar_y = plain_bar(4 * nb), plain_bar(p)
            outs = {
                # name: (kernel result, plain result, float64 product,
                #        plain bar, float64 bar); two-float pairs compare
                #        hi with hi and hi + lo with float64
                "crossprod": (tpk.crossprod_p(packed, mean, invsd, x),
                              tpk.crossprod_plain(packed, mean, invsd, x),
                              ref_z, bar_z, 1e-5),
                "matvec": (tpk.matvec_p(packed, mean, invsd, v),
                           tpk.matvec_plain(packed, mean, invsd, v),
                           ref_y, bar_y, 1e-5),
                "crossprod_ff": (tpk.crossprod_ff_p(packed, lut6, x),
                                 tpk.crossprod_ff_plain(packed, lut6, x),
                                 ref_z, bar_z, 5e-6),
                "matvec_ff": (tpk.matvec_ff_p(packed, lut6, v, vl),
                              tpk.matvec_ff_plain(packed, lut6, v, vl),
                              ref_yy, bar_y, 5e-6),
            }
            errs, rels = {}, {}
            for name, (got, plain, ref, bar, f64_bar) in outs.items():
                errs[name], rels[name] = hold(f"{name} {label} k={k}", got,
                                              plain, ref, bar, f64_bar)
            for name, e in errs.items():
                worst[name] = max(worst[name], e)
            say(f"   {label} k={k}: max abs err vs plain "
                + ", ".join(f"{n_}={e:.2e}" for n_, e in errs.items())
                + "; kernel vs float64 rel "
                + ", ".join(f"{n_}={e:.1e}" for n_, e in rels.items()))
        del packed, mean, invsd, lut6
    return worst


def check_tall_kernels(dev):
    """B5 and the tall two-float gram against their plain versions and
    against float64 products, on the kernel-check cases and at the tall
    width; there B1, B2 and B3 too, at the tall path's widths.  Returns
    {name: max abs err vs plain}: of the hi half for B5, of the pair's
    float64 sum for the gram and for B3.

    The gram's bar is componentwise, |kernel - plain| <= 2e-5 |plain| +
    4 eps32 (|W| |M y|): its second stage contracts n4 samples of
    y ~ sqrt(p) |w|, not unit-scale values, and with random tables each
    SNP's decoded values share a mean, so its entries and their partial
    sums reach ~1e7-1e8 while a few entries cancel to ~1e5.  (Its hi
    half alone is no yardstick: after thousands of 128-sample TwoSum
    folds the kernel and the plain version leave a different share of
    the sum in the err half.)  Against float64 the gram kernel is held
    to GRAM_F64_BAR, which the plain float32 gram of the same inputs
    (B2, mask, B1: no compensation) must miss at the tall width."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import valid_mask_permuted

    worst = {}
    for label, p, n, seed in KERNEL_CASES + (TALL_CASE,):
        packed, mean, invsd, lut6, nb, luts = random_operands(p, n, seed,
                                                              dev)
        valid = valid_mask_permuted(n, nb, torch.float32, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 200)
        for k in (3, 16, 28):
            v = torch.randn((p, k), generator=g, device=dev)
            ref_y = f64_product(packed, lut6, v, transpose=True)
            my = ref_y * valid.double()[:, None]
            ref_z = f64_product(packed, lut6, my, transpose=False)
            abs_z = f64_product(packed, lut6.abs(), my.abs(),
                                transpose=False)
            outs = {
                # name: (kernel, plain, float64, plain bar, float64 bar,
                #        compare the pairs' sums (else hi halves))
                "matvec_ff_novl": (
                    tpk.matvec_ff_novl_p(packed, lut6, v),
                    tpk.matvec_ff_novl_plain(packed, lut6, v),
                    ref_y, plain_bar(p), 5e-6, False),
                "gram_tall_ff": (
                    tpk.gram_tall_ff_p(packed, *luts, mean, invsd, v, valid),
                    tpk.gram_tall_ff_plain(packed, *luts, mean, invsd, v,
                                           valid),
                    ref_z, (2e-5, 4 * EPS32 * abs_z), 5e-6, True),
            }
            if label == TALL_CASE[0] and k > 3:
                # B1-B3 at the tall width and the tall path's panels (the
                # solver's 16, the polish's nev 28 -> kc 32); B3 by its
                # pairs' sums, as the gram: over 7,840 folds of 128
                # samples the kernel and the plain version leave
                # different shares of a sum in the err half
                x = torch.randn((4 * nb, k), generator=g, device=dev)
                ref_x = f64_product(packed, lut6, x, transpose=False)
                outs.update({
                    "crossprod": (tpk.crossprod_p(packed, mean, invsd, x),
                                  tpk.crossprod_plain(packed, mean, invsd, x),
                                  ref_x, plain_bar(4 * nb), 1e-5, False),
                    "matvec": (tpk.matvec_p(packed, mean, invsd, v),
                               tpk.matvec_plain(packed, mean, invsd, v),
                               ref_y, plain_bar(p), 1e-5, False),
                    "crossprod_ff": (tpk.crossprod_ff_p(packed, lut6, x),
                                     tpk.crossprod_ff_plain(packed, lut6, x),
                                     ref_x, plain_bar(4 * nb), 5e-6, True),
                })
            msg, rels = [], {}
            for name, (got, plain, ref, bar, f64_bar, sums) in outs.items():
                tag = f"{name} {label} k={k}"
                e, rels[name] = hold(tag, got, plain, ref, bar, f64_bar, sums)
                worst[name] = max(worst.get(name, 0.0), e)
                msg.append(f"{name} {e:.2e} (kernel vs float64 "
                           f"{rels[name]:.1e})")
            # the gram's tight float64 bar, and its control
            rel = rels["gram_tall_ff"]
            ctl = rel_err(tpk.crossprod_p(
                packed, mean, invsd,
                tpk.matvec_p(packed, mean, invsd, v) * valid[:, None]),
                ref_z)
            msg.append(f"plain float32 gram vs float64 {ctl:.1e}")
            if not rel < GRAM_F64_BAR:
                raise AssertionError(
                    f"gram_tall_ff {label} k={k}: vs float64 rel {rel:.2e} "
                    f"(bar {GRAM_F64_BAR})")
            if label == TALL_CASE[0] and not ctl >= GRAM_F64_BAR:
                raise AssertionError(
                    f"gram control {label} k={k}: the plain float32 gram "
                    f"reads {ctl:.2e} against float64, inside the two-float "
                    f"bar {GRAM_F64_BAR}: the bar cannot tell them apart")
            say(f"   {label} k={k}: max abs err vs plain " + "; ".join(msg))
        del packed, mean, invsd, lut6, luts, valid
    return worst


# ---------------------------------------------------------------------------
# Phase 4: mid-size PLINK fileset against a float64 oracle
# ---------------------------------------------------------------------------

def mid_size(dev, workdir, n=8001, p=4096, k=10, seed=5):
    import torch

    from flashpca_tpu_torch import PlinkDataset, check, pca
    from flashpca_tpu_torch.io.plink import write_bed
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    rng = np.random.default_rng(seed)
    pops = 12
    # unequal population sizes keep the structured eigenvalues apart,
    # so the eigenvectors are well determined for the comparison
    w = 0.8 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.1, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    geno[:, 7] = 1.0                                   # a constant SNP
    root = os.path.join(workdir, "mid")
    write_bed(root, geno)
    del geno

    ds = PlinkDataset.open(root)
    t0 = time.time()
    res = pca(root, k, device=dev)
    sync()
    t_pca = time.time() - t0
    chk = check(ds, res.vectors, res.values, device=dev)
    say(f"   pca({n} x {p}, k={k}): {t_pca:.2f} s, n_ops {res.n_ops}, "
        f"gate mse {res.gate_mse}, check mse {chk.mse:.3e}")

    mean, sd = ds.snp_stats("binom2")
    X = torch.as_tensor(dense_standardized_np(ds.read_codes(), mean, sd),
                        device=dev)                     # (p, n) float64
    lam, V = torch.linalg.eigh(X @ X.T)
    lam, V = lam.flip(0)[:k], V.flip(1)[:, :k]
    U = (X.T @ V) / lam.sqrt()[None, :]
    d_ref = lam.cpu().numpy() / p
    U_ref = U.cpu().numpy()
    del X, V, U
    rel = np.abs(res.values - d_ref) / d_ref
    # the float32 contract path takes its Ritz values from float32
    # products whose rounding is ~1e-7 of ||A|| (as in the JAX package),
    # so the bar is on the error relative to the largest eigenvalue
    rel_norm = np.abs(res.values - d_ref) / d_ref[0]
    rmse = np.array([min(np.linalg.norm(res.vectors[:, j] - U_ref[:, j]),
                         np.linalg.norm(res.vectors[:, j] + U_ref[:, j]))
                     for j in range(k)]) / np.sqrt(n)
    say(f"   vs float64 eigh: eigenvalue rel err max {rel.max():.2e} "
        f"(per value: {' '.join(f'{e:.1e}' for e in rel)}), relative to "
        f"the largest {rel_norm.max():.2e}; vector RMSE max "
        f"{rmse.max():.2e}")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()):
        raise AssertionError("mid-size: vectors not finite / wrong shape")
    if not rel_norm.max() < 1e-6:
        raise AssertionError(
            f"mid-size: eigenvalue err {rel_norm.max():.2e} of the largest")
    if not rmse.max() < 1e-5:
        raise AssertionError(f"mid-size: vector RMSE {rmse.max():.2e}")
    if not chk.mse < 1e-8:
        raise AssertionError(f"mid-size: check mse {chk.mse:.3e}")
    return {"n_ops": res.n_ops, "check_mse": chk.mse, "pca_s": t_pca,
            "eig_rel_err": float(rel.max()),
            "eig_err_of_largest": float(rel_norm.max()),
            "vec_rmse": float(rmse.max())}


# ---------------------------------------------------------------------------
# Phase 5: the headline
# ---------------------------------------------------------------------------

def generate_headline(n, p, seed, dev, pops=8, rows=1024):
    """Structured genotypes ~ Binom(2, f) with ``pops`` populations
    (sample i in population i % pops), packed on the card block by block
    into a (p, ceil(n/4)) uint8 tensor; allele frequencies per SNP and
    population from a seeded numpy generator, the draws from a seeded
    torch.Generator on the card."""
    import torch

    nb = (n + 3) // 4
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, size=p)
    delta = rng.normal(0.0, 0.05, size=(p, pops))
    thresh = torch.as_tensor(
        (np.clip(maf[:, None] + delta, 0.02, 0.98) * 256.0).astype(np.uint8),
        device=dev)                                            # (p, pops)
    sample = (4 * torch.arange(nb, device=dev)[:, None]
              + torch.arange(4, device=dev)[None, :])          # (nb, 4)
    pop = sample % pops
    pad = sample >= n
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.empty((p, nb), dtype=torch.uint8, device=dev)
    for r0 in range(0, p, rows):
        th = thresh[r0: r0 + rows][:, pop]                     # (r, nb, 4)
        u = torch.randint(0, 256, (2,) + tuple(th.shape), generator=g,
                          dtype=torch.uint8, device=dev)
        d = (u[0] < th).to(torch.uint8) + (u[1] < th).to(torch.uint8)
        # dosage -> PLINK code: 2 -> 0, 1 -> 2, 0 -> 3; byte padding 0
        code = (3 - d - (d >> 1)).masked_fill_(pad, 0)
        packed[r0: r0 + rows] = (code[..., 0] | (code[..., 1] << 2)
                                 | (code[..., 2] << 4) | (code[..., 3] << 6))
    return packed


def moments_on_card(packed, n, rows=2048):
    """Exact per-SNP dosage moments (ngood, dsum, d2sum) from the packed
    codes on the card (the numbers io/plink.py's snp_moments gives for a
    fileset), float64 on the host."""
    import torch

    p, nb = packed.shape
    sample = (4 * torch.arange(nb, device=packed.device)[None, :]
              + torch.arange(4, device=packed.device)[:, None])  # (4, nb)
    valid = sample < n
    counts = torch.zeros((p, 4), dtype=torch.int64, device=packed.device)
    for r0 in range(0, p, rows):
        blk = packed[r0: r0 + rows]
        for s in range(4):
            c = (blk >> (2 * s)) & 3
            for code in (0, 2, 3):
                counts[r0: r0 + rows, code] += (
                    (c == code) & valid[s]).sum(dim=1)
    c = counts.cpu().numpy().astype(np.float64)
    ngood = c[:, 0] + c[:, 2] + c[:, 3]
    return ngood, 2.0 * c[:, 0] + c[:, 2], 4.0 * c[:, 0] + c[:, 2]


def card_data(dev, n, p, seed):
    """Packed genotypes generated on the card with their exact stats:
    (packed, mean, sd, snp_sumsq)."""
    from flashpca_tpu_torch.io.plink import stats_from_moments
    from flashpca_tpu_torch.ops.standardize import sumsq_from_moments

    packed = generate_headline(n, p, seed, dev)
    ngood, dsum, d2sum = moments_on_card(packed, n)
    mean, sd = stats_from_moments(ngood, dsum, "binom2")
    return packed, mean, sd, sumsq_from_moments(ngood, dsum, d2sum, mean, sd)


def launch_medians(log):
    """{(kernel, kc): [ms, ...]} of a ``time_launches`` log, printed."""
    per = {}
    for name, kc, start, end in log:
        per.setdefault((name, kc), []).append(start.elapsed_time(end))
    for (name, kc), ts in sorted(per.items()):
        say(f"   {name:14s} kc={kc:2d}: {len(ts):3d} launches, median "
            f"{float(np.median(ts)):.2f} ms/launch")
    return {f"{nm}/{kc}": float(np.median(ts)) for (nm, kc), ts in per.items()}


def require_launched(launches, path, what):
    missing = [nm for nm in path if launches[nm] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {what}: "
                             f"{missing} (counts {launches})")


def headline(dev, n, p, k, seed=7):
    import torch

    from flashpca_tpu_torch import PackedOperator, check, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    out = {}
    with Phase(f"headline data: {n} x {p} generated on the card") as ph:
        packed, mean, sd, sumsq = card_data(dev, n, p, seed)
        op = PackedOperator(packed, mean, sd, n, device=dev,
                            snp_sumsq=sumsq)
        del packed
    out["gen_s"] = ph.seconds
    say(f"   packed {op.packed.numel() / 1e9:.2f} GB on the card")

    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before pca(), read just after
    # check(); every kernel of the path must have launched
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"pca(op, {k}) polish='contract' float32") as ph:
            res = pca(op, k)
        out["pca_s"] = ph.seconds
        with Phase("check(op, U, d)") as ph:
            chk = check(op, res.vectors, res.values)
        out["check_s"] = ph.seconds
    launches = dict(tpk.launch_counts)
    sync()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"   n_ops {res.n_ops}, n_restarts {res.n_restarts}, contract gate "
        f"mse {res.gate_mse:.4e} (accepts < 7e-9), check mse {chk.mse:.4e}, "
        f"converged {res.converged}")
    say(f"   pca wall {out['pca_s']:.2f} s, check wall {out['check_s']:.2f} s,"
        f" peak device memory {out['peak_gb']:.2f} GB")
    launch_ms = launch_medians(log)
    require_launched(launches, WIDE_PATH, "wide path")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and np.isfinite(res.values).all()):
        raise AssertionError("headline: non-finite or misshapen result")
    if not chk.mse < 1e-8:
        raise AssertionError(f"headline: check mse {chk.mse:.3e} >= 1e-8")
    if res.n_ops != 20:
        say(f"   note: n_ops {res.n_ops} differs from the JAX package's "
            "20 at this shape (a finding, not a failure)")
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               gate_mse=res.gate_mse, check_mse=chk.mse,
               launches=launches, launch_ms=launch_ms)
    return op, out


def f64_reference(top, nev, rows=2048):
    """Top ``nev`` eigenpairs of the float64 gram X^T X / p, formed on the
    card from the packed bytes (p x p, 20 GB at the tall headline) and
    solved by the port's block Lanczos in float64 to tol 1e-12."""
    import torch

    from flashpca_tpu_torch.ops.genotypes import decode_standardized
    from flashpca_tpu_torch.ops.standardize import lookup_tables
    from flashpca_tpu_torch.solvers.block_lanczos import eigsh_block

    dev = top.device
    p, nb = top.packed.shape
    mean, invsd = (torch.as_tensor(t, device=dev)
                   for t in lookup_tables(top.center, top.scale,
                                          dtype=np.float64))
    valid = top._valid.double()
    G = torch.zeros((p, p), dtype=torch.float64, device=dev)
    for b0 in range(0, nb, rows):
        Xc = decode_standardized(top.packed[:, b0: b0 + rows], mean, invsd,
                                 torch.float64)
        # decoded columns are permuted samples: plane s, bytes b0..b1
        nbc = Xc.shape[1] // 4
        m = valid.reshape(4, nb)[:, b0: b0 + nbc].reshape(-1)
        G.addmm_(Xc * m[None, :], Xc.T)
        del Xc
    G /= p
    res = eigsh_block(lambda x: G @ x, p, nev, block=16, ncv=160,
                      maxiter=200, tol=1e-12, dtype=torch.float64,
                      device=dev, seed=3)
    del G
    return res


def tall_headline(dev, n, p, k, seed=8):
    """The tall path at n >> p, held to the wide path on the same bytes
    and, with it, to a float64 eigendecomposition of X^T X."""
    import torch

    from flashpca_tpu_torch import (PackedOperator, TallPackedOperator, check,
                                    pca)
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    out = {}
    with Phase(f"tall data: {n} x {p} generated on the card") as ph:
        packed, mean, sd, sumsq = card_data(dev, n, p, seed)
        top = TallPackedOperator(packed, mean, sd, n, device=dev,
                                 snp_sumsq=sumsq)
        del packed
    out["gen_s"] = ph.seconds
    say(f"   packed {top.packed.numel() / 1e9:.2f} GB on the card")

    torch.cuda.reset_peak_memory_stats()
    # the tall path: counts set to 0 just before pca(), read just after;
    # B1, B2, B3 and B5 must have launched
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"tall pca(op, {k}) polish='contract' float32") as ph:
            res = pca(top, k, do_loadings=True)
    launches = dict(tpk.launch_counts)
    out["pca_s"] = ph.seconds
    sync()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launch_ms = launch_medians(log)
    require_launched(launches, TALL_PATH, "tall path")

    # the wide path on the same bytes (the tensor is shared, not copied)
    wide = PackedOperator(top.packed, mean, sd, n, device=dev,
                          snp_sumsq=sumsq)
    assert wide.packed.data_ptr() == top.packed.data_ptr()
    with Phase(f"wide pca(op, {k}) on the same bytes") as ph:
        res_w = pca(wide, k)
    out["wide_pca_s"] = ph.seconds
    with Phase("check() of both results through the wide operator") as ph:
        chk = check(wide, res.vectors, res.values)
        chk_w = check(wide, res_w.vectors, res_w.values)
    out["check_s"] = ph.seconds
    del wide

    d, d_w = res.values, res_w.values
    diff = np.abs(d - d_w)
    top_d = float(np.max(d_w))
    eig_err = float(np.max(diff) / top_d)
    # pairs in the Marchenko-Pastur bulk of X^T X / p, whose upper edge
    # is (sqrt(n) + sqrt(p))^2 / p (29.9 here; the population pairs sit
    # near 3,800), get the fixed bulk bar, the others EIG_BAR
    bulk = d_w < 1.5 * (np.sqrt(n) + np.sqrt(p)) ** 2 / p
    eig_bar = np.where(bulk, BULK_BAR, EIG_BAR) * top_d
    cos = np.abs(np.sum(res.vectors * res_w.vectors, axis=0)
                 / (np.linalg.norm(res.vectors, axis=0)
                    * np.linalg.norm(res_w.vectors, axis=0)))
    say(f"   tall: n_ops {res.n_ops}, n_restarts {res.n_restarts}, "
        f"converged {res.converged}, check mse {chk.mse:.4e}; wide: n_ops "
        f"{res_w.n_ops}, gate mse {res_w.gate_mse}, check mse "
        f"{chk_w.mse:.4e}")
    say(f"   tall pca wall {out['pca_s']:.2f} s, wide pca wall "
        f"{out['wide_pca_s']:.2f} s, peak device memory of the tall pca "
        f"{out['peak_gb']:.2f} GB")
    say(f"   eigenvalues: max |d_tall - d_wide| / max d_wide {eig_err:.3e}; "
        f"{int(bulk.sum())} pairs in the bulk; |d_tall - d_wide| / bar per "
        "pair: "
        + " ".join(f"{r:.2f}" for r in diff / eig_bar))
    say("   d_tall " + " ".join(f"{x:.6f}" for x in d))
    say("   d_wide " + " ".join(f"{x:.6f}" for x in d_w))
    say("   residual norms sqrt(err): tall "
        + " ".join(f"{x:.1e}" for x in np.sqrt(chk.err)) + "; wide "
        + " ".join(f"{x:.1e}" for x in np.sqrt(chk_w.err)))
    say("   |cos| of the tall and wide vector pairs "
        + " ".join(f"{c:.7f}" for c in cos))
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and np.isfinite(res.values).all()):
        raise AssertionError("tall headline: non-finite or misshapen result")
    if not res.converged:
        raise AssertionError("tall headline: the solve did not converge")
    if not np.all(diff <= eig_bar):
        raise AssertionError(
            f"tall headline: eigenvalues {np.flatnonzero(diff > eig_bar)} "
            f"off the wide path's beyond {EIG_BAR} of the largest "
            f"({BULK_BAR} in the bulk; max {eig_err:.3e})")
    if not chk.mse <= max(1e-8, 2.0 * chk_w.mse):
        raise AssertionError(f"tall headline: check mse {chk.mse:.3e} > "
                             f"max(1e-8, 2 x wide {chk_w.mse:.3e})")
    if res.n_ops != 40:
        say(f"   note: n_ops {res.n_ops} differs from the 40 that the JAX "
            "package's tall bench recorded at this shape (a finding, not a "
            "failure)")
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               check_mse=chk.mse, wide_n_ops=res_w.n_ops,
               wide_gate_mse=res_w.gate_mse, wide_check_mse=chk_w.mse,
               eig_err_of_largest=eig_err, min_abs_cos=float(cos.min()),
               launches=launches, launch_ms=launch_ms)
    with Phase("float64 reference: X^T X / p on the card, eigsh") as ph:
        ref = f64_reference(top, k + 8)
    d_ref = ref.eigenvalues[:k]
    V_ref = ref.eigenvectors[:, :k].cpu().numpy()
    cos_ref = np.abs(np.sum(res.loadings * V_ref, axis=0)
                     / np.linalg.norm(res.loadings, axis=0))
    say(f"   reference: {ref.n_ops} passes, converged {ref.converged}")
    say("   d_ref " + " ".join(f"{x:.6f}" for x in d_ref))
    errs = {}
    for who, dd in (("tall", d), ("wide", d_w)):
        say(f"   (d_{who} - d_ref) / d_ref max: "
            + " ".join(f"{x:.2e}" for x in (dd - d_ref) / d_ref[0]))
        # above: EIG_BAR both ways (Ritz values of a float32 subspace
        # are lower bounds up to rounding); below: EIG_BAR, or BULK_BAR
        # in the bulk, which neither float32 path resolves pair by pair
        off = (dd - d_ref) / d_ref[0]
        bad = (off > EIG_BAR) | (-off > np.where(bulk, BULK_BAR, EIG_BAR))
        if not ref.converged or bad.any():
            raise AssertionError(
                f"tall headline: {who} eigenvalues {np.flatnonzero(bad)} "
                f"off the float64 reference beyond {EIG_BAR} of the "
                f"largest above it or below it ({BULK_BAR} below it in "
                "the bulk)")
        errs[who] = float(np.max(np.abs(dd - d_ref)) / d_ref[0])
    say("   |cos| tall loadings vs reference: "
        + " ".join(f"{c:.7f}" for c in cos_ref))
    out.update(ref_s=ph.seconds, tall_eig_err_vs_f64=errs["tall"],
               wide_eig_err_vs_f64=errs["wide"])
    return top, out


# ---------------------------------------------------------------------------
# Phase 6: kernel times at the headline shapes
# ---------------------------------------------------------------------------

def event_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (ms), after one
    warm-up run."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def library_ms(op, calls, ff, slices):
    """Device time of the torch.matmul calls that compute the same
    product on the matrix already decoded to float32, summed over SNP
    slices (the whole decoded matrix, 201 GB at the headline, does not
    fit the card).  ``calls(sl, Wh, Wl)`` returns the matmuls of one
    slice as thunks; ``ff`` decodes the two-float tables (Wh, Wl) in
    place of the plain standardized values (Wh).  Decoding is not
    timed."""
    import torch

    from flashpca_tpu_torch.ops.compensated import decode_lut
    from flashpca_tpu_torch.ops.genotypes import decode_standardized

    lh, ll = op._ff_luts()
    rows = -(-op.n_snps // slices)
    total = 0.0
    for i, r0 in enumerate(range(0, op.n_snps, rows)):
        sl = slice(r0, r0 + rows)
        blk = op.packed[sl]
        if ff:
            Wh = decode_lut(blk, lh[sl])
            Wl = decode_lut(blk, ll[sl])
        else:
            Wh = decode_standardized(blk, op.mean[sl], op.invsd[sl],
                                     torch.float32)
            Wl = None
        thunks = calls(sl, Wh, Wl)
        if i == 0:
            for t in thunks:
                t()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for t in thunks:
            t()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
        del Wh, Wl
    return total


def kernel_specs(op, widths):
    """Timing specs at ``op``'s shapes, one per (kernel, k) in
    ``widths``: (kernel thunk, plain thunk, torch.matmul thunks per
    decoded slice, two-float tables?, bytes moved: inputs once, outputs
    once)."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    dev = op.device
    p, nb = op.packed.shape
    n4 = 4 * nb
    g = torch.Generator(device=dev).manual_seed(99)
    pk, m, iv = op.packed, op.mean, op.invsd
    lut6 = tpk.lut_rows(*op._ff_luts())
    specs = {}
    for name, k in widths:
        x = torch.randn((n4, k), generator=g, device=dev)
        v = torch.randn((p, k), generator=g, device=dev)
        vl = torch.randn((p, k), generator=g, device=dev) * 1e-7
        specs[name, k] = {
            "crossprod": lambda x=x: (
                lambda: tpk.crossprod_p(pk, m, iv, x),
                lambda: tpk.crossprod_plain(pk, m, iv, x),
                lambda sl, Wh, Wl: [lambda: Wh @ x], False,
                p * nb + n4 * k * 4 + 3 * p * 4 + p * k * 4),
            "matvec": lambda v=v: (
                lambda: tpk.matvec_p(pk, m, iv, v),
                lambda: tpk.matvec_plain(pk, m, iv, v),
                lambda sl, Wh, Wl: [lambda: Wh.T @ v[sl]], False,
                p * nb + p * k * 4 + 3 * p * 4 + n4 * k * 4),
            "crossprod_ff": lambda x=x: (
                lambda: tpk.crossprod_ff_p(pk, lut6, x),
                lambda: tpk.crossprod_ff_plain(pk, lut6, x),
                lambda sl, Wh, Wl: [lambda: Wh @ x, lambda: Wl @ x], True,
                p * nb + 6 * p * 4 + n4 * k * 4 + 2 * p * k * 4),
            "matvec_ff": lambda v=v, vl=vl: (
                lambda: tpk.matvec_ff_p(pk, lut6, v, vl),
                lambda: tpk.matvec_ff_plain(pk, lut6, v, vl),
                lambda sl, Wh, Wl: [lambda: Wh.T @ v[sl],
                                    lambda: Wl.T @ v[sl],
                                    lambda: Wh.T @ vl[sl]], True,
                p * nb + 6 * p * 4 + 2 * p * k * 4 + 2 * n4 * k * 4),
            "matvec_ff_novl": lambda v=v: (
                lambda: tpk.matvec_ff_novl_p(pk, lut6, v),
                lambda: tpk.matvec_ff_novl_plain(pk, lut6, v),
                lambda sl, Wh, Wl: [lambda: Wh.T @ v[sl],
                                    lambda: Wl.T @ v[sl]], True,
                p * nb + 6 * p * 4 + p * k * 4 + 2 * n4 * k * 4),
        }[name]()
    return specs


def time_kernels(op, widths, launches, worst, slices):
    """One row of the ``kernels`` JSON per (kernel, k) in ``widths``,
    timed at ``op``'s shapes: kernel, plain version and torch.matmul on
    the same block decoded to float32 (decode untimed, ``slices`` SNP
    slices), beside the bound."""
    p, nb = op.packed.shape
    rows = []
    for (name, k), (kern, plain, lib, ff, nbytes) in kernel_specs(
            op, widths).items():
        ms = event_ms(kern, reps=5)
        plain_ms = event_ms(plain, reps=1)
        lib_ms = library_ms(op, lib, ff, slices)
        flops = 2.0 * DOTS[name] * k * p * 4 * nb
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        bound = max(t_ops, t_bytes)
        say(f"   {name:14s} k={k}: kernel {ms:.2f} ms, plain {plain_ms:.2f} "
            f"ms, torch.matmul {lib_ms:.2f} ms, bound {bound:.2f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "k": k, "shape": [p, 4 * nb],
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=501_760)
    ap.add_argument("--p", type=int, default=100_352)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU only", file=sys.stderr)
        return 1
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from flashpca_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    with Phase("build kernels (nvcc, sm_90a)") as ph:
        build_dir = _build.build_all()
    build_s = ph.seconds
    say(f"   built into {os.path.relpath(build_dir)}")
    for src in _build.sources():
        fn = "?"
        with open(os.path.join(build_dir,
                               f"{os.path.splitext(src)[0]}.log")) as fh:
            for line in fh:   # nvcc -Xptxas -v: registers, smem, spills
                m = re.search(r"Compiling entry function '\w*?\d([a-z_]+"
                              r"_kernel)ILi(\d+)E(?:Lb([01])E)?", line)
                if m:
                    fn = f"{m.group(1)} kc={m.group(2)}" + (
                        f" has_vl={m.group(3)}" if m.group(3) else "")
                m = re.search(r"(Used \d+ registers.*)", line)
                if m:
                    say(f"   {src} {fn}: {m.group(1).strip()}")
    with Phase("kernels against their plain versions"):
        worst = check_kernels(dev)
    torch.cuda.empty_cache()
    with Phase("tall kernels against their plain versions"):
        for name, e in check_tall_kernels(dev).items():
            worst[name] = max(worst.get(name, 0.0), e)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("mid-size PLINK fileset against float64 eigh"):
            mid = mid_size(dev, tmp)
    torch.cuda.empty_cache()
    op, head = headline(dev, args.n, args.p, args.k)
    torch.cuda.empty_cache()
    with Phase("kernel times at the headline shapes"):
        # B1/B2 at the solver panel, B3/B4 at the polish / check width
        kernels = time_kernels(
            op, [("crossprod", 16), ("matvec", 16), ("crossprod_ff", 24),
                 ("matvec_ff", 24)], head["launches"], worst, slices=32)
    del op
    torch.cuda.empty_cache()
    top, tall = tall_headline(dev, TALL_N, TALL_P, args.k)
    torch.cuda.empty_cache()
    with Phase("kernel times at the tall shapes"):
        # B5 at the polish width (nev 28 -> kc 32); B1-B3 at their tall
        # widths (B1/B2 the solver panel, B1/B3 the polish)
        tall_rows = time_kernels(
            top, [("matvec_ff_novl", 32), ("crossprod", 16), ("matvec", 16),
                  ("crossprod", 32), ("crossprod_ff", 32)],
            tall["launches"], worst, slices=64)
    kernels.append(tall_rows[0])
    say(json.dumps({"summary": {
        "card": smi, "n": args.n, "p": args.p, "k": args.k,
        "build_s": build_s, "mid": mid,
        **{key: val for key, val in head.items()},
        "gram_tall_ff_max_abs_err": worst["gram_tall_ff"],
        "tall": {"n": TALL_N, "p": TALL_P, **tall,
                 "kernels": tall_rows},
        "total_s": time.time() - t_start}}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
