"""Packed genotypes too large for one card, SNP-sharded over the cards of
one process, and the program's sharded wide operator on them.

The configuration's ``shards`` devices (``cuda:0`` ... on the card, the
CPU repeated off it) each hold an equal run of the cohort's SNP blocks:
the blocks in the order the seed draws over the whole axis (gen.py's
``order``), shard s taking positions [s m, (s + 1) m) of the m blocks a
shard.  Each device generates its own blocks by ``gen.generate``'s rule
for a block (the same thresholds and per-block generator), so the shards
laid end to end are ``gen.generate``'s array byte for byte; the devices
take turns a block at a time, so that they generate at the same time.
The per-SNP moments are taken a shard at a time and joined in float64.

The operator is ``PackedOperator`` over a one-process ``Mesh`` of those
devices (no process group), the wide gram X X^T (``operator_mode`` auto
or wide; this cohort has no tall path), and ``check()`` runs on it too.
The reference's products decode each shard on its own device and sum
the shards' float64 partials on the first.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen, reference
from portbench.cohorts.resident_packed import PRODUCTS

# SNP rows a shard's reference decodes before the next shard's turn: the
# devices' queues are fed in turn, so that they decode at the same time
REFERENCE_ROWS = 8192


def devices(kind: str, shards: int) -> list:
    """The mesh's devices: one card a shard on CUDA, the CPU repeated."""
    if kind == "cuda":
        return [torch.device(f"cuda:{i}") for i in range(shards)]
    return [torch.device(kind)] * shards


class _Draw:
    """``gen.generate``'s per-block rule on one device."""

    def __init__(self, n: int, thresh: np.ndarray, structure: dict, dev):
        nb = (n + 3) // 4
        self.dev = dev
        self.cseed = int(structure["cohort_seed"])
        self.miss = int(structure["missing_per_10000"])
        self.thresh = torch.as_tensor(thresh, device=dev)
        sample = (4 * torch.arange(nb, device=dev)[:, None]
                  + torch.arange(4, device=dev)[None, :])       # (nb, 4)
        self.pop = sample % structure["pops"]
        self.pad = sample >= n

    def block(self, b: int) -> torch.Tensor:
        """SNP block ``b``'s (ROWS, nb) packed bytes."""
        dev = self.dev
        g = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence([self.cseed, b]).generate_state(1)[0]))
        th = self.thresh[b * gen.ROWS: (b + 1) * gen.ROWS][:, self.pop]
        u = torch.randint(0, 256, (2,) + tuple(th.shape), generator=g,
                          dtype=torch.uint8, device=dev)
        d = (u[0] < th).to(torch.uint8) + (u[1] < th).to(torch.uint8)
        # dosage -> PLINK code: 2 -> 0, 1 -> 2, 0 -> 3
        code = 3 - d - (d >> 1)
        if self.miss:
            m = torch.randint(0, 10000, tuple(th.shape), generator=g,
                              dtype=torch.int16, device=dev) < self.miss
            code.masked_fill_(m, 1)
        code.masked_fill_(self.pad, 0)                          # byte padding
        return (code[..., 0] | (code[..., 1] << 2) | (code[..., 2] << 4)
                | (code[..., 3] << 6))


def generate_shards(n: int, p: int, seed: int, structure: dict,
                    devs: list) -> tuple:
    """(shards, snp_index): the cohort's SNP blocks in the seed's order,
    split into equal runs, shard s generated on ``devs[s]``."""
    nblocks, nshards = p // gen.ROWS, len(devs)
    if p % gen.ROWS or nblocks % nshards:
        raise ValueError(f"{p} SNPs are not whole blocks of {gen.ROWS} "
                         f"in {nshards} equal shards")
    per = nblocks // nshards
    blocks = gen.order(nblocks, nblocks, seed)
    thresh = gen.thresholds(p, int(structure["cohort_seed"]), structure)
    draws = [_Draw(n, thresh, structure, d) for d in devs]
    shards = [torch.empty((per * gen.ROWS, (n + 3) // 4), dtype=torch.uint8,
                          device=d) for d in devs]
    for q in range(per):
        for s, draw in enumerate(draws):
            shards[s][q * gen.ROWS: (q + 1) * gen.ROWS] = draw.block(
                int(blocks[s * per + q]))
    snp_index = (blocks[:, None] * gen.ROWS
                 + np.arange(gen.ROWS)[None, :]).ravel()
    return shards, snp_index


class Cohort:
    """The genotypes of a configuration, generated shard by shard from
    ``seed`` on the mesh's devices, the program's sharded operator on
    them, and the float64 reference's products on the same bytes."""

    products = PRODUCTS

    def __init__(self, config: dict, seed: int, device, cpu_kernels=False):
        from flashpca_tpu_torch import PackedOperator
        from flashpca_tpu_torch.io.plink import stats_from_moments
        from flashpca_tpu_torch.ops.standardize import sumsq_from_moments
        from flashpca_tpu_torch.parallel import Mesh

        n, p = config["n_samples"], config["n_snps"]
        self.n, self.p = n, p
        mode = config["operator_mode"]
        if mode == "tall" or (mode == "auto" and n > 2 * p):
            raise ValueError("the sharded cohort runs the wide gram X X^T "
                             f"only; n = {n} > 2p picks the tall one")
        devs = devices(torch.device(device).type, int(config["shards"]))
        self.shards, self.snp_index = generate_shards(
            n, p, seed, config["structure"], devs)
        moments = [gen.moments(s, n) for s in self.shards]
        ngood, dsum, d2sum = (np.concatenate(m) for m in zip(*moments))
        mean, sd = stats_from_moments(ngood, dsum, "binom2")
        sumsq = sumsq_from_moments(ngood, dsum, d2sum, mean, sd)
        # the CPU has no kernels: their plain versions run the same path
        kw = (dict(dtype=torch.float32, use_kernels=True) if cpu_kernels
              else {})
        self.op = PackedOperator(self.shards, mean, sd, n,
                                 mesh=Mesh([str(d) for d in devs]),
                                 n_snps=p, snp_sumsq=sumsq, **kw)
        self.wide = self.op

    @property
    def device(self):
        return self.shards[0].device

    def operators(self) -> list:
        return [self.op]

    def free_program(self) -> None:
        """Drop the program's operator; the shards stay for the
        reference."""
        self.op = self.wide = None

    # -- the float64 reference on the same bytes ----------------------------
    def gram_columns(self, U: torch.Tensor) -> torch.Tensor:
        """X X^T U, float64, for an (n, m) float64 panel on the first
        device: each shard's partial on its own device, REFERENCE_ROWS
        SNPs a shard in turn, then the partials summed on the first in
        shard order."""
        stats = [reference.binom2_stats(s, self.n) for s in self.shards]
        Us = [U.to(s.device) for s in self.shards]
        accs = [torch.zeros_like(u) for u in Us]
        for r0 in range(0, self.shards[0].shape[0], REFERENCE_ROWS):
            sl = slice(r0, r0 + REFERENCE_ROWS)
            for s, (mean, inv) in enumerate(stats):
                accs[s] += reference.gram_columns(
                    self.shards[s][sl], self.n, mean[sl], inv[sl], Us[s])
        out = accs[0]
        for acc in accs[1:]:
            out = out + acc.to(out.device)
        return out
