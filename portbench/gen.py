"""Genotypes generated on the device, frozen for the benchmark.

A copy of ``chip_smoke.py``'s ``generate_headline`` and
``moments_on_card`` (lines 2236-2289 of that file when the copy was
taken), with three changes: a share of missing calls (PLINK code 1)
drawn from the same generators; the population structure read from the
configuration; and the cohort drawn from the configuration's
``cohort_seed`` a block of SNPs at a time, the run's seed choosing only
the order along the axis the gram sums over: the SNP blocks for the
wide gram X X^T, the byte columns (groups of four samples) for the tall
gram X^T X.  Every seed so holds the same cohort and the same gram, in
another order of its terms: the solver does the same work from the
same start, which a new cohort a seed would change (PERF.md, section
2).  Kept here so that a change to the smoke cannot change the
benchmark's inputs.

Sample ``i`` of the cohort belongs to population ``i % pops``; each SNP
draws its allele frequency from U(maf_lo, maf_hi) and each population's
shift from N(0, shift_sd) with a numpy generator seeded by the cohort
seed; the genotypes are two Bernoulli draws against those frequencies
(on a 256-level grid) from a ``torch.Generator`` on the device, seeded
by the cohort seed and the block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ROWS = 1024          # SNPs generated per block


@dataclass
class Cohort:
    packed: torch.Tensor      # (p, ceil(n / 4)) uint8 PLINK codes
    snp_index: np.ndarray     # position -> the cohort's SNP
    sample_index: np.ndarray  # position -> the cohort's sample


def thresholds(p: int, seed: int, structure: dict) -> np.ndarray:
    """(p, pops) uint8 allele-frequency thresholds on a 256-level grid."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(structure["maf_lo"], structure["maf_hi"], size=p)
    delta = rng.normal(0.0, structure["shift_sd"],
                       size=(p, structure["pops"]))
    return (np.clip(maf[:, None] + delta, 0.02, 0.98) * 256.0).astype(
        np.uint8)


def order(units: int, whole: int, seed: int) -> np.ndarray:
    """The first ``whole`` of ``units`` permuted by ``seed``; a partial
    last unit stays last."""
    return np.concatenate([np.random.default_rng(seed).permutation(whole),
                           np.arange(whole, units)])


def generate(n: int, p: int, seed: int, structure: dict, device,
             axis: str = "snps") -> Cohort:
    """The configuration's cohort with the SNP blocks (``axis="snps"``)
    or the byte columns (``"samples"``) in the order ``seed`` draws.

    ``structure`` holds ``cohort_seed``, ``pops``, ``maf_lo``, ``maf_hi``,
    ``shift_sd`` and ``missing_per_10000`` (the share of calls set
    missing)."""
    nb = (n + 3) // 4
    pops = structure["pops"]
    miss = int(structure["missing_per_10000"])
    cseed = int(structure["cohort_seed"])
    thresh = torch.as_tensor(thresholds(p, cseed, structure), device=device)
    sample = (4 * torch.arange(nb, device=device)[:, None]
              + torch.arange(4, device=device)[None, :])        # (nb, 4)
    pop = sample % pops
    pad = sample >= n
    nblocks = -(-p // ROWS)
    if axis == "snps":
        blocks, cols = order(nblocks, p // ROWS, seed), np.arange(nb)
    elif axis == "samples":
        blocks, cols = np.arange(nblocks), order(nb, n // 4, seed)
    else:
        raise ValueError(f"axis must be 'snps' or 'samples', got {axis!r}")
    cols_dev = torch.as_tensor(cols, device=device)
    packed = torch.empty((p, nb), dtype=torch.uint8, device=device)
    for q, b in enumerate(blocks):
        r0, r1 = b * ROWS, min(p, (b + 1) * ROWS)
        g = torch.Generator(device=device).manual_seed(
            int(np.random.SeedSequence([cseed, int(b)]).generate_state(1)[0]))
        th = thresh[r0:r1][:, pop]                              # (r, nb, 4)
        u = torch.randint(0, 256, (2,) + tuple(th.shape), generator=g,
                          dtype=torch.uint8, device=device)
        d = (u[0] < th).to(torch.uint8) + (u[1] < th).to(torch.uint8)
        # dosage -> PLINK code: 2 -> 0, 1 -> 2, 0 -> 3
        code = 3 - d - (d >> 1)
        if miss:
            m = torch.randint(0, 10000, tuple(th.shape), generator=g,
                              dtype=torch.int16, device=device) < miss
            code.masked_fill_(m, 1)
        code.masked_fill_(pad, 0)                               # byte padding
        byte = (code[..., 0] | (code[..., 1] << 2) | (code[..., 2] << 4)
                | (code[..., 3] << 6))
        q0 = q * ROWS
        packed[q0: q0 + (r1 - r0)] = byte[:, cols_dev]
    snp_index = (blocks[:, None] * ROWS + np.arange(ROWS)[None, :]).ravel()
    snp_index = snp_index[snp_index < p]
    sample_index = (4 * cols[:, None] + np.arange(4)[None, :]).ravel()[:n]
    return Cohort(packed, snp_index, sample_index)


def moments(packed: torch.Tensor, n: int, rows: int = 2048):
    """Exact per-SNP dosage moments (ngood, dsum, d2sum) from the packed
    codes, counted on the bytes' device, float64 on the host."""
    p, nb = packed.shape
    dev = packed.device
    sample = (4 * torch.arange(nb, device=dev)[None, :]
              + torch.arange(4, device=dev)[:, None])           # (4, nb)
    valid = sample < n
    counts = torch.zeros((p, 4), dtype=torch.int64, device=dev)
    for r0 in range(0, p, rows):
        blk = packed[r0: r0 + rows]
        for s in range(4):
            c = (blk >> (2 * s)) & 3
            for code in (0, 2, 3):
                counts[r0: r0 + rows, code] += ((c == code)
                                                & valid[s]).sum(dim=1)
    c = counts.cpu().numpy().astype(np.float64)
    ngood = c[:, 0] + c[:, 2] + c[:, 3]
    return ngood, 2.0 * c[:, 0] + c[:, 2], 4.0 * c[:, 0] + c[:, 2]
