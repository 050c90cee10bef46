#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashpca_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, all in this one process; any failure raises and exits nonzero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels B1-B4 from kernels/csrc (timed set-up);
3. hold each kernel against its plain PyTorch version on the card, at
   full width (501,760 samples) on a 4,096-SNP slice and on a small odd
   case (n % 4 != 0, some inv_sd == 0), panels k in {3, 16, 24}; the
   two-float kernels also against a float64 product;
4. a mid-size PLINK fileset (8,001 x 4,096, written by the port's
   write_bed) through ``pca(root, 10)`` and ``check()``, against a
   float64 dense eigendecomposition;
5. the headline: structured genotypes 501,760 x 100,352 generated on the
   card (12.6 GB packed, never decoded whole), ``pca(op, 20)`` with
   ``polish="contract"`` at float32, then ``check(op, U, d)``; the
   kernels' launch counts are reset just before ``pca`` and read just
   after ``check``, and every kernel must have run;
6. each kernel timed at the headline shapes beside its bound, its plain
   version and the torch.matmul calls on the same block decoded to
   float32.

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

TPU_KERNEL = {
    "crossprod": "flashpca_tpu/kernels/packed_matvec.py:83",
    "matvec": "flashpca_tpu/kernels/packed_matvec.py:122",
    "crossprod_ff": "flashpca_tpu/kernels/packed_matvec.py:336",
    "matvec_ff": "flashpca_tpu/kernels/packed_matvec.py:369",
}
SOURCE = {name: f"flashpca_tpu_torch/kernels/csrc/{name}.cu"
          for name in TPU_KERNEL}
# float32 dots per genotype and panel column
DOTS = {"crossprod": 1, "matvec": 1, "crossprod_ff": 2, "matvec_ff": 3}
# kernel-check shapes (label, SNPs, samples, seed): a full-width slice of
# the headline and a small odd case (n % 4 != 0)
KERNEL_CASES = (("full width 4096 x 501760", 4096, 501_760, 21),
                ("odd 333 x 1001", 333, 1001, 22))


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
    """Assert |got - want| <= atol + rtol |want| elementwise; return the
    max absolute error."""
    g = got.double()
    w = want.double()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if not bool(g.isfinite().all()) or bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries off "
            f"(max abs err {float(err.max()):.3e}, rtol {rtol}, atol {atol})")
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
    lh, ll = code_value_luts(mean, sd)
    lut6 = tpk.lut_rows(torch.as_tensor(lh, device=dev),
                        torch.as_tensor(ll, device=dev))
    return (packed, torch.as_tensor(m32, device=dev),
            torch.as_tensor(i32, device=dev), lut6, nb)


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


def check_kernels(dev):
    """Each kernel against its plain version and against a float64
    product, on a full-width slice and a small odd case.  Returns
    {kernel: max abs err against the plain version}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    worst = {name: 0.0 for name in TPU_KERNEL}
    for label, p, n, seed in KERNEL_CASES:
        packed, mean, invsd, lut6, nb = random_operands(p, n, seed, dev)
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
            for name, (got, plain, ref, (rtol, atol), f64_bar) in outs.items():
                tag = f"{name} {label} k={k}"
                ff = isinstance(got, tuple)
                errs[name] = close(tag, got[0] if ff else got,
                                   plain[0] if ff else plain, rtol, atol)
                for who, r in (("kernel", got), ("plain", plain)):
                    r = r[0].double() + r[1].double() if ff else r.double()
                    e = rel_err(r, ref)
                    if not e < f64_bar:
                        raise AssertionError(f"{tag} {who}: vs float64 rel "
                                             f"{e:.2e} (bar {f64_bar})")
                    if who == "kernel":
                        rels[name] = e
            for name, e in errs.items():
                worst[name] = max(worst[name], e)
            say(f"   {label} k={k}: max abs err vs plain "
                + ", ".join(f"{n_}={e:.2e}" for n_, e in errs.items())
                + "; kernel vs float64 rel "
                + ", ".join(f"{n_}={e:.1e}" for n_, e in rels.items()))
        del packed, mean, invsd, lut6
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


def headline(dev, n, p, k, seed=7):
    import torch

    from flashpca_tpu_torch import PackedOperator, check, pca
    from flashpca_tpu_torch.io.plink import stats_from_moments
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.standardize import sumsq_from_moments

    out = {}
    with Phase(f"headline data: {n} x {p} generated on the card") as ph:
        packed = generate_headline(n, p, seed, dev)
        ngood, dsum, d2sum = moments_on_card(packed, n)
        mean, sd = stats_from_moments(ngood, dsum, "binom2")
        sumsq = sumsq_from_moments(ngood, dsum, d2sum, mean, sd)
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
    per = {}
    for name, kc, start, end in log:
        per.setdefault((name, kc), []).append(start.elapsed_time(end))
    say(f"   n_ops {res.n_ops}, n_restarts {res.n_restarts}, contract gate "
        f"mse {res.gate_mse:.4e} (accepts < 7e-9), check mse {chk.mse:.4e}, "
        f"converged {res.converged}")
    say(f"   pca wall {out['pca_s']:.2f} s, check wall {out['check_s']:.2f} s,"
        f" peak device memory {out['peak_gb']:.2f} GB")
    for (name, kc), ts in sorted(per.items()):
        say(f"   {name:13s} kc={kc:2d}: {len(ts):3d} launches, median "
            f"{float(np.median(ts)):.2f} ms/launch")
    missing = [nm for nm, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} (counts {launches})")
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
               launches=launches,
               launch_ms={f"{nm}/{kc}": float(np.median(ts))
                          for (nm, kc), ts in per.items()})
    return op, out


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


def library_ms(op, calls, ff, slices=32):
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


def time_kernels(op, launches, worst):
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    dev = op.device
    p, nb = op.packed.shape
    n4 = 4 * nb
    g = torch.Generator(device=dev).manual_seed(99)
    k_plain, k_ff = 16, 24          # the solver panel; the polish / ff width
    x16 = torch.randn((n4, k_plain), generator=g, device=dev)
    v16 = torch.randn((p, k_plain), generator=g, device=dev)
    x24 = torch.randn((n4, k_ff), generator=g, device=dev)
    v24 = torch.randn((p, k_ff), generator=g, device=dev)
    vl24 = torch.randn((p, k_ff), generator=g, device=dev) * 1e-7
    pk, m, iv = op.packed, op.mean, op.invsd
    lut6 = tpk.lut_rows(*op._ff_luts())

    specs = {
        "crossprod": (
            k_plain,
            lambda: tpk.crossprod_p(pk, m, iv, x16),
            lambda: tpk.crossprod_plain(pk, m, iv, x16),
            lambda sl, Wh, Wl: [lambda: Wh @ x16], False,
            p * nb + n4 * k_plain * 4 + 3 * p * 4 + p * k_plain * 4),
        "matvec": (
            k_plain,
            lambda: tpk.matvec_p(pk, m, iv, v16),
            lambda: tpk.matvec_plain(pk, m, iv, v16),
            lambda sl, Wh, Wl: [lambda: Wh.T @ v16[sl]], False,
            p * nb + p * k_plain * 4 + 3 * p * 4 + n4 * k_plain * 4),
        "crossprod_ff": (
            k_ff,
            lambda: tpk.crossprod_ff_p(pk, lut6, x24),
            lambda: tpk.crossprod_ff_plain(pk, lut6, x24),
            lambda sl, Wh, Wl: [lambda: Wh @ x24, lambda: Wl @ x24], True,
            p * nb + 6 * p * 4 + n4 * k_ff * 4 + 2 * p * k_ff * 4),
        "matvec_ff": (
            k_ff,
            lambda: tpk.matvec_ff_p(pk, lut6, v24, vl24),
            lambda: tpk.matvec_ff_plain(pk, lut6, v24, vl24),
            lambda sl, Wh, Wl: [lambda: Wh.T @ v24[sl],
                                lambda: Wl.T @ v24[sl],
                                lambda: Wh.T @ vl24[sl]], True,
            p * nb + 6 * p * 4 + 2 * p * k_ff * 4 + 2 * n4 * k_ff * 4),
    }
    rows = []
    # name: (k, kernel, plain version, torch.matmul thunks per slice,
    #        two-float tables?, bytes moved: inputs once, outputs once)
    for name, (k, kern, plain, lib, ff, nbytes) in specs.items():
        ms = event_ms(kern, reps=5)
        plain_ms = event_ms(plain, reps=1)
        lib_ms = library_ms(op, lib, ff)
        flops = 2.0 * DOTS[name] * k * p * n4
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        bound = max(t_ops, t_bytes)
        say(f"   {name:13s} k={k}: kernel {ms:.2f} ms, plain {plain_ms:.2f} "
            f"ms, torch.matmul {lib_ms:.2f} ms, bound {bound:.2f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
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
    for name in TPU_KERNEL:
        kc = "?"
        with open(os.path.join(build_dir, f"{name}.log")) as fh:
            for line in fh:   # nvcc -Xptxas -v: registers, smem, spills
                m = re.search(r"Compiling entry function .*ILi(\d+)E", line)
                kc = m.group(1) if m else kc
                m = re.search(r"(Used \d+ registers.*)", line)
                if m:
                    say(f"   {name} kc={kc}: {m.group(1).strip()}")
    with Phase("kernels against their plain versions"):
        worst = check_kernels(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("mid-size PLINK fileset against float64 eigh"):
            mid = mid_size(dev, tmp)
    torch.cuda.empty_cache()
    op, head = headline(dev, args.n, args.p, args.k)
    torch.cuda.empty_cache()
    with Phase("kernel times at the headline shapes"):
        kernels = time_kernels(op, head["launches"], worst)
    say(json.dumps({"summary": {
        "card": smi, "n": args.n, "p": args.p, "k": args.k,
        "build_s": build_s, "mid": mid,
        **{key: val for key, val in head.items()},
        "total_s": time.time() - t_start}}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
