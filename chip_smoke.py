#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashpca_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, all in this one process; any failure raises and exits nonzero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels from kernels/csrc, twenty-two
   entries in fourteen libraries: B1-B5, the kernel sweep's tile entries
   of B1 and B2 and its variants V1-V4 of B1, the first designs of B1-B4
   and V1-V4, and B5's comparison entries -- its first design and its
   design at C = 4 columns per thread or CR = 128 rows per chunk (timed
   set-up); each instantiation's registers and spills (ptxas; production
   B2, B3 and B4 and the redesigned V1-V4 must spill nothing), and the
   instruction mix of B5's, B4's, B3's, B2's, B1's, V1's, V2's and V4's
   inner loops in each (cuobjdump; V2's loop at kc 16 must have B1's
   length and FFMA count), and of V3's tensor-core loop its
   HMMA and its CUDA-core instructions a genotype (printed beside its
   bound, which counts only the work the function needs);
3. hold each kernel against its plain PyTorch version on the card, at
   full width (501,760 samples) on a 4,096-SNP slice and on a small odd
   case (n % 4 != 0, some inv_sd == 0), panels k in {3, 16, 24}, and
   each against a float64 product; there also V1-V4 and their first
   designs (V3 within 5e-5 of float64, the others 1e-5), B1-B4 and
   V1-V4 each bit-equal to its first design (torch.equal,
   both halves of B3 and B4, at every case and k of this phase, B1-B4
   at the tall width's too), B1's tile entries and
   B2's at 64 rows a chunk bit-equal to B1 and B2, and B2's at 32 and
   128 against B2's plain version.  B5 (and its comparison entries) and the
   tall two-float gram (B5, mask, B3, B1) likewise on those cases and at
   the tall width (2,048 SNPs x 1,003,520 samples), panels k in {3, 16,
   24, 28}, and there B1-B3 at k in {16, 24, 28}; the gram within
   1.5e-7 of float64, which the plain float32 gram (B2, mask, B1) must
   miss at the tall width (the gram with B5 at CR = 128 is measured
   against float64 beside it);
4. the streaming operator (StreamingPackedOperator): the bytes of a
   full-width slice (4,096 SNPs in eleven blocks at ``memory_mb=98``) and
   of the small odd case (nine blocks), generated on the card, copied to
   the host and streamed back with the prefetch worker on and off and
   with three blocks cached; three back-to-back products of each kind
   (the plain gram at kc 16, ``crossprod``, ``prod``, the two-float
   gram at kc 24), no synchronisation between them, each torch.equal to
   the same blocks' products summed in the same order from the bytes
   held whole, and ``crossprod`` to B1 on all of them;
   the tall streaming operator (TallStreamingOperator) likewise, in the
   same three configurations, on a slice of the tall headline's width
   (2,048 SNPs x 1,003,520 samples in its twelve blocks of 21,396
   bytes), a small odd case (n % 4 != 0, a last block of 11 bytes) and
   a case read from a .bed memmap written here: two back-to-back plain
   grams, two-float grams and ``prod`` at kc 16 and 32 each, torch.equal
   to the same blocks' kernel calls summed in block order;
   a mid-size PLINK fileset (8,001 x 4,096, written by the port's
   write_bed) through ``pca(root, 10)`` and ``check()``, against a
   float64 dense eigendecomposition, and then streamed from its .bed
   memmap (``streaming=True, memory_mb=1``): eigenvalues within 2e-6
   relative of the resident run, check mse < 1e-8; then float64 on the
   card (the functional core; no kernel may launch): wide and tall
   ``pca(root, 10, dtype=float64)`` held to the dense float64 eigh
   (eigenvalues within 1e-9 of the largest, vectors RMSE < 1e-6),
   ``check()`` at float64 (mse < 1e-8) and the wide run streamed from
   the memmap within 1e-12 relative of the resident one; then the CLI
   on the card: ``pca`` writes loadings and meansd under ``--profile``
   (its Chrome trace must name CUDA kernel events of B1 and B2),
   ``--project
   --inload --inmeansd`` reads them back (B2), ``--ucca --pheno`` a
   phenotype file written here (B1), each held to a numpy float64
   oracle (the projection's columns within 1e-6 of their norms; ucca's
   R within 1e-5 relative, F 2e-5, -log10 P 1e-4 absolute), and
   ``--ucca --batch`` (the numeric-matrix path: a float64
   DenseOperator on the card) held to ``--ucca`` at those bars; then the fileset as a numeric
   matrix: ``pca(ds.read_matrix(impute_mean=False), 10)`` at float32 and
   at float64 on the card and ``flashpca()`` on it (a DenseOperator,
   no kernel launched), held to the dense float64 eigh, the CLI's
   ``--batch`` pca then ``--check`` (mse < 1e-8), and a float64
   ``pca(root, 20, checkpoint_every=1)`` whose first mid-run .npz
   resumes with ``state_in`` to eigenvalues within 1e-6 of the largest;
   then SCCA on the fileset (``mid_scca``): 5 phenotypes, two carrying
   20 SNPs' effects, ``scca(root, Y, 2.5 / sqrt(p), 0.02, ndim=2)`` at
   float32 (B1 and B2 must launch), at float64 (no launch) and streamed
   (``memory_mb=1``, the host engine), float32 and streamed held to
   float64 (d within 1e-5 relative, U and V 2e-4); the CLI's ``--scca``
   held to its ``--dtype float64`` run, and its ``--outstate`` cut after
   dimension 1 and resumed with ``--instate`` byte for byte; then SCCA
   penalty selection on the fileset (``mid_cv_split``): ``cv_scca``
   (5 folds, ``init=True``) and ``split_scca`` on a 3 x 3 grid at
   float32 (B1 and B2 must launch), each held to the same call at
   float64 (no launch) and to its sequential fallback
   (``engine="host"``), ``cv_scca`` streamed (``memory_mb=1``) to the
   resident run and on the numeric matrix at float32 to float64 (no
   launch): correlations within CV_CORR_BAR, flags equal, the best cell
   the same but for a tie within CV_TIE_BAR, non-zeros within
   CV_NZ_SHARE; then two processes with torch.distributed on the
   fileset (``mp_mesh``: NCCL across two cards, or gloo with both ranks
   on the one card; each rank ``python3 chip_smoke.py --mp-rank R`` with
   240 s, reading only its shard's bytes): wide ``pca`` + ``check`` at
   float32 (B1-B4 on every rank) and float64 (no launch), the wide and
   the tall path streamed (``memory_mb=1``), the tall path and ``scca``
   (ndim 2), the ranks bit-equal and each held to the one-process run
   on the card (float32 eigenvalues 2e-5, float64 1e-10, check mse <
   1e-8, scca d 1e-4 and U, V 1e-3), the collectives timed;
5. the wide headline: structured genotypes 501,760 x 100,352 generated
   on the card (12.6 GB packed, never decoded whole), ``pca(op, 20)``
   with ``polish="contract"`` at float32, then ``check(op, U, d)``; the
   kernels' launch counts are reset just before ``pca`` and read just
   after ``check``, and every kernel of the wide path (B1-B4) must have
   run; then the same bytes on a 2-shard mesh of the card
   (``sharded_headline``: row views, no copy), ``pca`` and ``check``
   with the counts around them (B1-B4 must launch), eigenvalues within
   1e-5 relative of the one-shard run, check mse < 1e-8, ``n_ops`` and
   the gate's mse printed beside the one-shard run's, B1 and B2 timed at
   kc 16 at one shard's shape; then ``project`` and ``ucca`` on the
   same operator, counts
   reset just before and read just after each: the headline's loadings
   (one crossprod of its vectors, B1) projected back by
   ``_project_operator(op, V, p)`` (B2 at kc 24), held to the float64
   W^T V / sqrt(p) over all SNPs (the population PCs' columns within
   1e-6 of their norms, every column within 1e-6 of the largest one's),
   its 7 population PCs to ``res.projection`` at |cos| >= 1 - 1e-6;
   ``ucca(op, Y)`` on 7 seeded phenotypes, each carrying one SNP's
   effect (B1 at kc 8), held on the causal SNPs' 512-SNP window to a
   float64 crossprod's R, F and P at the CLI's bars, the causal SNPs at
   P < 1e-8; then SCCA (``scca_headline``): 10 phenotypes, three with
   a planted 200-SNP direction added through one prod pass,
   ``scca(op, Y, 2.5 / sqrt(p), 0.02, ndim=3, maxiter=100, tol=1e-4)``
   (counts reset just before and read just after: B1 and B2 must
   launch, on one column, which the wrappers pad to kc 8), held to
   converge with every d > 0, finite Px and Py,
   and one iteration redone in float64 on a float64 PackedOperator over
   the same bytes (the functional core) moving u and v by at most 1e-3
   and d by 1e-5 relative; then ``scca_grid`` over the 4 x 4 penalty
   grid (B1 and B2 at kc 16), its cell 9 held to the solo run (d 1e-4
   relative, U and V 1e-3, iterations within 2); then B1-B4 timed at
   the headline shapes (B1/B2 at kc 16 and 24, B3/B4 at 24, B1/B2 on
   scca's one column) beside their bounds, their plain versions and the
   torch.matmul calls on the same block decoded to float32, and B1 (kc
   16), B2 (kc 16 and 24), B3 (kc 24) and B4 (kc 24) beside their first
   designs in turns; then the same bytes, copied to the host and the
   resident operator freed, streamed under ``memory_mb=2048`` (the
   reference's "2GB": twelve blocks of up to 8,559 SNPs, no cache): a
   staging trial (a gram pass with the prefetch worker on, then one
   with it off) and the link's rate on one block, then ``pca(op, 20)`` and
   ``check()`` (counts reset just before, read just after: B1-B4 must
   have run, no first design) held to the resident run -- check mse <
   1e-8, eigenvalues within 2e-6 relative, every vector's |cos| >= 1 -
   1e-6 (in a pair closer than TWIN_NEAR of the largest, which a
   float32 solve does not resolve one by one, the pair's span may hold
   it instead; two resident solves from different start seeds are
   printed beside it as the witness), the packed bytes on the card
   within 2048 MiB -- with the
   staging seconds, the packed GB/s, the kernels' busy share and their
   per-launch medians on the blocks; then ``ucca`` and
   ``_project_operator`` on the streamed operator (counts around each:
   B1 for ucca, B2 for project), ucca equal to the resident result bit
   for bit, project within 1e-6 relative of it; SCCA (``streamed_scca``:
   one dimension, 5 iterations at tol 0 on the host engine, U and V
   within 1e-4 of the resident device engine's; a 16-cell zero-penalty
   grid staging no more block passes than one solo run); then B1-B4,
   B2 at kc 24, B1 at kc 8 and B1/B2 on one column timed on one block
   held resident; then
   penalty selection at all 501,760 samples (``headline_cv_split``):
   the first D SNPs of the same bytes written as a PLINK fileset, D the
   largest multiple of 4,096 whose time, estimated from one timed
   repack of 4,096 SNPs, fits CV_BUDGET_S, the free disk checked;
   ``split_scca`` (train 0.8) and ``cv_scca`` (3 folds, ``init=True``)
   on the 4 x 4 grid (lambda1 / sqrt(D)), counts reset just before and
   read just after each: the grid path (the split's B1 and B2 launches
   exactly its grid's steps, d passes and projections), the best split
   cell held to a solo ``scca()`` on its train fileset, its dim-1 test
   correlation to a float64 recomputation within 1e-5 and at least 0.8,
   three repacked rows to the source's codes, no scratch left; the
   repack's seconds and GB/s, and init, grid and projection seconds,
   per fold; B1 and B2 timed at kc 16 on the split's and the first
   fold's train operators; then
   the dense
   headline (``dense_headline``): 50,176 x 100,352 genotypes generated
   packed on the card, decoded there into one float32 X (20.1 GB) and
   held by ``DenseOperator(X, center=mean, scale=sd)`` (torch.matmul
   products, no kernel: no launch may be counted): ``pca(dense, 20)``
   and ``check()``, their extra peak device memory at most 0.25 x X's
   bytes; the resident PackedOperator's ``pca`` and ``check`` on the
   same bytes (B1-B4 must launch); the dense result's check mse < 1e-8
   through both operators, its eigenvalues within 1e-6 of the largest
   of the packed run's, its vectors by the twin rule; ``ucca`` of 7
   seeded phenotypes on both, held to a float64 crossprod on the causal
   window; the dense plain and two-float gram timed a pass;
6. the kernel sweep (flashpca_tpu_torch.tools.kernel_sweep) at the wide
   headline's shape, 100,352 x 501,760, k=16, after the headline's
   operator is freed: V1-V4 and their first designs against B1 on a
   512-SNP slice, B1/B2 at each tile, B1 at k in {8, 16, 32, 64}, V1-V4
   bit-equal to their first designs at the full shape, and B1, V1-V4
   and the four first designs timed in turns, each beside B1 (B1 less
   V4: what the compensation costs B1), their plain versions and bounds
   (V3's and its first design's: the largest of its tensor-core
   products, its bytes and the CUDA-core work the function needs, with
   each design's own CUDA-core instructions a genotype beside it, V3's
   from its SASS); launch counts reset just before it and read just after
   (V1-V4, the first designs and the tile entries must have launched;
   none of them is on the main path, whose count of each is 0);
7. the tall headline: 1,003,520 x 50,176 generated the same way, held
   by a ``TallPackedOperator``; ``pca(op, 20)`` with
   ``polish="contract"`` at float32 on the tall path (counts reset just
   before, read just after: B1, B2, B3 and B5 must have run), then the
   wide path's ``pca`` on the same bytes and ``check()`` of both results
   through the wide operator: the tall check mse must stay within
   max(1e-8, 2 x the wide one); each eigenvalue of the two paths within
   2e-6 of the largest of each other and of a float64 eigendecomposition
   of X^T X / p formed on the card (p x p float64, 20 GB, ~100 s), save
   that in the Marchenko-Pastur bulk the bar below is 3.6e-5 (and
   between the paths 3.6e-5 both ways); one float64 gram pass timed
   and, where 250 passes of it would exceed 65 s, the SNP depth cut
   (never the samples) to fit, then ``pca(TallPackedOperator(...,
   dtype=float64), 20)`` on that depth through the functional core (no
   kernel may launch), its eigenvalues within 2e-6 of the largest of
   the float64 eigendecomposition of that depth's gram (the leading
   block of the same X^T X / p) for every pair; then the same bytes on
   2 byte-column shards of the card (``sharded_tall``), ``pca`` and
   ``check()`` through a 2-shard wide operator, held as the sharded
   headline (B1, B2, B3 and B5 must launch), B1 and B2 timed at kc 16
   at one shard's shape; then B5 at kc 32 and 24 (and
   B1-B3 at their tall widths: B1 and B2 at 16, 24, 32, B3 at 24, 32)
   timed at the tall shapes, and beside B5, on the same inputs, its
   comparison entries, B1 at kc 16 and 32, B2 at kc 16, 24 and 32 and B3
   at kc 24 and 32 beside their first designs in turns; and B4, which
   the tall path does not run, at kc 24 on the tall bytes (the wide
   operator's check of a tall result) beside its first design;
8. the tall headline's bytes, copied to the host and the resident
   operator freed, streamed in blocks of samples under
   ``memory_mb=2048`` (twelve blocks of 21,396 bytes, the last 15,524,
   no cache): ``pca(op, 20)`` (counts reset just before, read just
   after: B1, B2, B3 and B5 must have run, no first design), then
   ``check()`` of its result through the wide streaming operator at the
   same bound, held to the resident tall run -- the same ``n_ops``,
   check mse < 1e-8 and within max(1e-8, 2 x the resident one),
   eigenvalues within 2e-6 of the largest, every vector by the
   TWIN_NEAR rule, the packed bytes on the card within 2048 MiB -- with
   the staging seconds, the packed GB/s and the kernels' busy share and
   medians; then B1 (kc 16, 32), B2 (16), B3 (32) and B5 (32) timed on
   one resident block of that shape.

The headlines must give wide ``n_ops`` 20 and tall ``n_ops`` 32, and no
launch of a first design or comparison entry on either main path.  The
line before the last is the JSON ``{"kernels": [...]}`` (B1-B5 at the
widths the headlines launch and B4 at the tall bytes' kc 24, the first
designs of B1-B5 from the timing phases, V1-V4 and their first designs
from the sweep, B1-B4 at the streamed block's shape with ``"path":
"streaming"``, B1, B2, B3 and B5 at the streamed tall block's with
``"path": "tall_streaming"``, B2 at kc 24, B1 at kc 8 and B1/B2 on one
column with ``"path": "project"``, ``"ucca"`` and ``"scca"`` at the
headline's shape, B1/B2 at kc 16 with ``"scca_grid"`` (the solver
panel's rows with the grid's launches), and ``"project_streaming"``,
``"ucca_streaming"``, ``"scca_streaming"`` and ``"scca_grid_streaming"``
at the streamed block's, B1/B2 at kc 16 with ``"split_scca"`` and
``"cv_scca"`` on their train bytes, B1/B2 at kc 16 with ``"sharded"``
and ``"sharded_tall"`` at one shard's shape), with a ``streaming`` entry (the streamed
path's launches and per-launch medians, and under ``tall`` the streamed
tall path's); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from flashpca_tpu_torch.kernels._build import kernel_name, ptxas_usage

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
# eigenvalue gap, in units of the largest, below which the streamed
# headline holds a vector by its cluster's span, not by its |cos| with
# the resident twin: to first order a pair of gap g rotates by
# (coupling) / g, and the float32 solves' couplings are of the order of
# their eigenvalues' disagreement (up to 2.5e-6 in the bulk, about
# 1.3e-9 of the largest), which at g of 1e-6 of the largest turns a
# pair by about 1.3e-3 rad, near the |cos| bar's 1.4e-3, and below it
# by more; the witness: the resident solve from another start seed
TWIN_NEAR, WITNESS_SEED = 1e-6, 2

TPU_KERNEL = {
    "crossprod": "flashpca_tpu/kernels/packed_matvec.py:83",
    "crossprod_v1": "flashpca_tpu/kernels/packed_matvec.py:83",
    "matvec": "flashpca_tpu/kernels/packed_matvec.py:122",
    "matvec_v1": "flashpca_tpu/kernels/packed_matvec.py:122",
    "crossprod_ff": "flashpca_tpu/kernels/packed_matvec.py:336",
    "crossprod_ff_v1": "flashpca_tpu/kernels/packed_matvec.py:336",
    "matvec_ff": "flashpca_tpu/kernels/packed_matvec.py:369",
    "matvec_ff_v1": "flashpca_tpu/kernels/packed_matvec.py:369",
    "matvec_ff_novl": "flashpca_tpu/kernels/packed_matvec.py:415",
    "matvec_ff_novl_v1": "flashpca_tpu/kernels/packed_matvec.py:415",
    "crossprod_narrow": "flashpca_tpu/kernels/packed_matvec.py:83",
    "matvec_narrow": "flashpca_tpu/kernels/packed_matvec.py:122",
    "crossprod_stacked": ".claude/skills/verify/kernel_sweep.py:50",
    "crossprod_stacked_v1": ".claude/skills/verify/kernel_sweep.py:50",
    "crossprod_intsub": ".claude/skills/verify/kernel_sweep.py:128",
    "crossprod_intsub_v1": ".claude/skills/verify/kernel_sweep.py:128",
    "crossprod_split3": ".claude/skills/verify/kernel_sweep.py:209",
    "crossprod_split3_v1": ".claude/skills/verify/kernel_sweep.py:209",
    "crossprod_nocomp": ".claude/skills/verify/kernel_sweep.py:261",
    "crossprod_nocomp_v1": ".claude/skills/verify/kernel_sweep.py:261",
}
_CSRC = "flashpca_tpu_torch/kernels/csrc/"
SOURCE = {"crossprod": _CSRC + "crossprod_v2.cu",
          "crossprod_v1": _CSRC + "crossprod.cu",
          "matvec": _CSRC + "matvec_v2.cu", "matvec_v1": _CSRC + "matvec.cu",
          "crossprod_ff": _CSRC + "crossprod_ff_v2.cu",
          "crossprod_ff_v1": _CSRC + "crossprod_ff.cu",
          "matvec_ff": _CSRC + "matvec_ff_v2.cu",
          "matvec_ff_v1": _CSRC + "matvec_ff.cu",
          "matvec_ff_novl": _CSRC + "matvec_ff_novl.cu",
          "matvec_ff_novl_v1": _CSRC + "matvec_ff.cu",
          "crossprod_narrow": _CSRC + "crossprod_narrow.cu",
          "matvec_narrow": _CSRC + "matvec_narrow.cu",
          "crossprod_stacked": _CSRC + "crossprod_variants_v2.cu",
          "crossprod_stacked_v1": _CSRC + "crossprod_variants.cu",
          "crossprod_intsub": _CSRC + "crossprod_variants_v2.cu",
          "crossprod_intsub_v1": _CSRC + "crossprod_variants.cu",
          "crossprod_split3": _CSRC + "crossprod_split3_v2.cu",
          "crossprod_split3_v1": _CSRC + "crossprod_split3.cu",
          "crossprod_nocomp": _CSRC + "crossprod_variants_v2.cu",
          "crossprod_nocomp_v1": _CSRC + "crossprod_variants.cu"}
# float32 dots per genotype and panel column (V3's products are bf16:
# SPLIT3_BF16_DOTS of them, and its decode is bounded apart)
DOTS = {"crossprod": 1, "crossprod_v1": 1, "matvec": 1, "matvec_v1": 1,
        "crossprod_ff": 2, "crossprod_ff_v1": 2, "matvec_ff": 3,
        "matvec_ff_v1": 3,
        "matvec_ff_novl": 2, "matvec_ff_novl_v1": 2,
        "crossprod_narrow": 1, "matvec_narrow": 1,
        "crossprod_stacked": 1, "crossprod_stacked_v1": 1,
        "crossprod_intsub": 1, "crossprod_intsub_v1": 1,
        "crossprod_nocomp": 1, "crossprod_nocomp_v1": 1}
SPLIT3_BF16_DOTS = 3
PEAK_BF16_FLOPS = 989e12      # dense tensor-core rate, H100 SXM
# V3's first design's own CUDA-core work per genotype, counted from
# crossprod_split3.cu: code to float, the factored cubic's sub, 2 muls, 2
# adds and mul (unfused, as its plain version rounds them), the split's
# sub and one paired bf16 conversion per piece (half an instruction per
# value each) -- 9 instructions, at one per lane and clock, 33.5e12/s.
# The redesign's is read from its SASS (split3_ops_per_genotype).  Both
# are reported beside the bound, which counts only what the function
# needs (split3_needed_ops_per_genotype).
SPLIT3_OPS_PER_GENOTYPE = 9
PEAK_FP32_INSTR = PEAK_FP32_FLOPS / 2
# the CUDA-core work V3's function needs per genotype, whatever the
# design: the A words' pick (a 32-bit A register holds two genotypes of
# a row, and its hi and lo words are one byte permute each: 1 a
# genotype) and the TwoSum fold every 32 bytes (128 samples) that the
# first design's bits fix (6 adds and err += e, 7 a column: 7 kc / 128)
SPLIT3_PICK_OPS = 1
SPLIT3_FOLD_OPS, SPLIT3_FOLD_SAMPLES = 7, 128
# the kernel sweep's variants (kernels/crossprod_variants.py) and their
# first designs, and V3's bars: against its plain version three
# float32 contractions' worth of plain_bar (tensor-core sums are not IEEE
# add sequences), against float64 5e-5 (its dropped lo*lo term:
# 4.5-4.7e-6 on the CPU)
VARIANTS = ("crossprod_stacked", "crossprod_intsub", "crossprod_split3",
            "crossprod_nocomp")
VARIANT_FIRSTS = ("crossprod_stacked_v1", "crossprod_intsub_v1",
                  "crossprod_nocomp_v1", "crossprod_split3_v1")
SWEEP_PATH = VARIANTS + VARIANT_FIRSTS + ("crossprod_tiled", "matvec_tiled")
F64_BAR = {"crossprod_stacked": 1e-5, "crossprod_stacked_v1": 1e-5,
           "crossprod_intsub": 1e-5, "crossprod_intsub_v1": 1e-5,
           "crossprod_split3": 5e-5, "crossprod_split3_v1": 5e-5,
           "crossprod_nocomp": 1e-5, "crossprod_nocomp_v1": 1e-5}
SWEEP_K = 16
# the kernels each main path must launch
WIDE_PATH = ("crossprod", "matvec", "crossprod_ff", "matvec_ff")
TALL_PATH = ("crossprod", "matvec", "crossprod_ff", "matvec_ff_novl")
PROJECT_PATH = ("matvec",)               # project(): one prod pass, B2
UCCA_PATH = ("crossprod",)               # ucca(): one crossprod pass, B1
# a solo scca(): B1 u-steps and B2 v-steps on one column, through their
# one-column kernels; a grid's (scca_grid, cv_scca, split_scca) on its
# cells' panel
SCCA_PATH = ("crossprod_narrow", "matvec_narrow")
SCCA_GRID_PATH = ("crossprod", "matvec")
# a solo fit of 2-8 dimensions ends on Px = X U: B2 on its ndim columns,
# at kc 8
SCCA_PX = ("matvec",)
# float64 on the card runs the functional core; the mid-size runs are
# held to dense float64 eigh: a float64 solve stops at residuals of 1e-6
# of each eigenvalue, so a pair's eigenvalue is off by about that
# squared over its relative gap (~0.2 between the populations here:
# 5e-12) and its vector by 1e-6 over the gap (RMSE ~6e-8 at n = 8,001)
F64_EIG_BAR, F64_VEC_RMSE = 1e-9, 1e-6
# project() against float64 products: each population PC's column
# within 1e-6 of its own norm, every column within 1e-6 of the largest
# column's norm.  B1 and B2 decode with float32 constants whose per-SNP
# offsets are ~1e-6 absolute (20 float32 ulps; the same decode measured
# on the CPU), which move a projected column by ~1e-6 ||V_j|| a sample:
# 1e-6 of the column's norm only where d_j p / n ~ 1, as for the
# Marchenko-Pastur bulk PCs (d ~ 10 at the headline), 20x below it for
# the population PCs (d ~ 2e3), so the bulk columns are held, like the
# eigenvalues, against the largest
PROJECT_BAR = 1e-6
# ucca() against a float64 oracle: R relative, F relative (r^2 / (1 -
# r^2), twice R's), -log10 P absolute
UCCA_R_BAR, UCCA_F_BAR, UCCA_LOGP_BAR = 1e-5, 2e-5, 1e-4
# ucca() at the headline: 7 phenotypes, so its panel is 8 columns (B1 at
# kc 8), each carrying one causal SNP's effect at 0.02 standard
# deviations per standard deviation (r^2 ~ 4e-4: F ~ 29, P ~ 1e-40 at
# n = 501,760, well inside float64), the causal SNPs in a 512-SNP
# window that the float64 oracle covers
UCCA_K, UCCA_BETA, UCCA_SLICE = 7, 0.02, 512
# the tall headline at float64 (the functional core on the card, ~5.7 s
# a gram pass at full depth, decode-bound): its solve's time budget; the
# passes it takes, which grow with the SNP depth (118, 168 and 226 at
# 2,048, 4,096 and 6,144 SNPs of the 1,003,520 samples on the H100:
# tools/tall_f64_depths.py and this script, PERF.md), taken as 250; and
# the restarts it may take before it fails.  65 s cuts the depth to
# 2,048 SNPs on the H100 for a full pass of 5.0-6.3 s (~30 s of solve;
# 120 s gave 4,096 in ~80 s, 180 s 6,144 in ~162 s): the sharded
# phases' time came out of it (PERF.md section 4)
F64_SOLVE_S, F64_PASSES, F64_MAXITER = 65.0, 250, 400
# kernel-check shapes (label, SNPs, samples, seed): a full-width slice of
# the headline and a small odd case (n % 4 != 0); the tall kernels also
# run at the tall headline's width
KERNEL_CASES = (("full width 4096 x 501760", 4096, 501_760, 21),
                ("odd 333 x 1001", 333, 1001, 22))
TALL_CASE = ("tall width 2048 x 1003520", 2048, 1_003_520, 23)
# the headlines' populations (POPS - 1 population PCs lead the spectrum)
POPS = 8
# SCCA at the wide headline, the JAX package's sparse-SCCA bench
# configuration (bench.py): SCCA_K phenotypes from default_rng(SCCA_SEED),
# SCCA_NDIM of them carrying one planted sparse direction of SCCA_PLANT
# SNPs each at 3 / std, lambda1 = SCCA_L1 / sqrt(p), lambda2 = SCCA_L2,
# V0 from seed SCCA_V0_SEED
SCCA_K, SCCA_NDIM, SCCA_PLANT, SCCA_SEED, SCCA_V0_SEED = 10, 3, 200, 11, 7
SCCA_L1, SCCA_L2, SCCA_MAXITER, SCCA_TOL = 2.5, 0.02, 100, 1e-4
# one iteration redone in float64 from the float32 result moves no entry
# of u or v by more than 10 x tol, and d recomputed in float64 is within
# SCCA_D_BAR relative of the result's
SCCA_FIXED_BAR, SCCA_D_BAR = 10 * SCCA_TOL, 1e-5
# the 4 x 4 penalty grid (lambda1 in units of 1 / sqrt(p)); its cell
# SCCA_GRID_CELL (row-major) is the solo run's, held to it: d within
# SCCA_GRID_D_BAR relative, U and V within SCCA_GRID_UV_BAR, iterations
# per dimension within SCCA_GRID_ITERS (the grid's B1/B2 run at kc 16,
# the solo's at kc 8: the same fixed point, reached in other roundings)
SCCA_GRID_L1 = (1.5, 2.0, 2.5, 3.0)
SCCA_GRID_L2 = (0.01, 0.02, 0.05, 0.1)
SCCA_GRID_CELL = 9
SCCA_GRID_D_BAR, SCCA_GRID_UV_BAR, SCCA_GRID_ITERS = 1e-4, 1e-3, 2
# streamed SCCA (host engines, float64 host arithmetic around float32
# products) against the resident device engine (float32 throughout),
# SCCA_TWIN_ITERS iterations at tol 0 from the same V0: U and V within
# SCCA_STREAM_BAR; the streamed grid runs SCCA_STREAM_GRID_ITERS
SCCA_TWIN_ITERS, SCCA_STREAM_GRID_ITERS, SCCA_STREAM_BAR = 5, 3, 1e-4
# float32 SCCA against float64 (d relative, U and V absolute) on the
# mid-size fileset at tol SCCA_MID_TOL, and its CLI's pcsX/pcsY columns
# relative in their norms (tol 1e-5 stops each fit within about 1e-5 of
# its fixed point: the U/V bar leaves 20x over that)
SCCA_MID_TOL, SCCA_F32_D_BAR, SCCA_F32_UV_BAR, SCCA_F32_PC_BAR = (
    1e-5, 1e-5, 2e-4, 1e-3)
# penalty selection (cv_scca, split_scca) against float64, and each path
# against its twin (the sequential fallback, streamed, the matrix
# input).  A test correlation is a Pearson correlation of two
# projections whose inputs U and V sit within SCCA_F32_UV_BAR of
# float64's: over ~1,600-8,000 test rows that moves it by ~1e-5, and
# CV_CORR_BAR leaves 10x over it, where both runs converged.  The best
# cell is the same unless its correlation is within CV_TIE_BAR of the
# runner-up's (a tie within the bar may fall either way).  Non-zero
# counts are within CV_NZ_SHARE of float64's: an entry within rounding
# of its threshold may land on either side in float32, and 2% of a
# cell's non-zeros leaves room for that and not for a different fit
CV_CORR_BAR, CV_TIE_BAR, CV_NZ_SHARE = 1e-4, 1e-4, 0.02
# the mid-size search: a 3 x 3 grid (lambda1 in units of 1 / sqrt(p))
CV_MID_L1, CV_MID_L2 = (1.5, 2.5, 3.5), (0.01, 0.02, 0.05)
# the headline search on its first D SNPs: the phase's time budget (the
# estimate from one timed repack of CV_PROBE_SNPS SNPs sets D: 8,192 on
# an H100's host at 70 s, 4,096 at 50 s, cut for the sharded phases: the
# script must end within 1,200 s on the slowest host: PERF.md section
# 5), the CV's
# folds and the split's share of training samples; the best split
# cell's dim-1 test correlation recomputed in float64 within
# CV_F64_CORR_BAR, and at least CV_MIN_CORR (the planted directions at
# 3 / std give ~0.95)
CV_BUDGET_S, CV_PROBE_SNPS, CV_FOLDS, CV_PROP_TRAIN = 50.0, 4096, 3, 0.8
CV_F64_CORR_BAR, CV_MIN_CORR = 1e-5, 0.8
# the card's share of the headline phase in the estimate: its grids,
# init runs and projections, ~27 s at the full 100,352 SNPs by the
# headline SCCA's grid (5.02 s) and solo run (1.87 s) on an H100 (PERF.md
# section 6), so 3e-4 s a SNP, beside CV_FIXED_S for the rest
# (phenotypes, the solo and float64 holds, the kernel rows)
CV_CARD_S_PER_SNP, CV_FIXED_S = 3e-4, 40.0
# sharding: the one-process headline phases' shard count on the card;
# their eigenvalues against the one-shard run's on the same bytes (float32
# runs of the same products summed in another order: 1e-5 relative, the
# issue's bar; the mid-size streamed run's against its resident one,
# another order too, meets 2e-6)
SHARDS, SHARD_EIG_BAR = 2, 1e-5
# the two-process phase on the mid-size fileset: processes, each rank's
# time limit (tests/test_multiprocess.py's), k, the float32 and float64
# eigenvalue bars against the one-process run (the CPU tests' two-process
# bars: tests/test_torch_multiprocess.py), and the seed of its scca's
# phenotypes (mid_phenotypes: the mid-size phase's seed, mid_scca's
# problem)
MP_NPROC, MP_TIMEOUT_S, MP_K, MP_SEED = 2, 240, 10, 5
MP_F32_BAR, MP_F64_BAR = 2e-5, 1e-10
# the tall headline: the JAX package's tall bench shape (bench.py)
TALL_N, TALL_P = 1_003_520, 50_176
# the dense headline: the headline's SNP width with a tenth of its
# samples as one float32 matrix on the card (20.1 GB; 50,176 is not a
# multiple of the 2,048-row two-float chunk), the generator's seed, and
# the bound on the extra peak device memory of its pca() and check(),
# as a share of X's bytes (a copy of X would be 1.0)
DENSE_N, DENSE_P, DENSE_SEED, DENSE_PEAK_SHARE = 50_176, 100_352, 17, 0.25
# how far, in units of the largest, the dense headline's bulk pairs may
# fall below the float64 reference's: the capped float32 schedule on
# this wide gram leaves them up to 7.43e-5 (dense) and 6.63e-5 (packed)
# below it on an H100, about twice the tall headline's BULK_BAR
DENSE_BULK_F64_BAR = 1.5e-4


def sass_hot_loops(sass):
    """{kernel<template args>: Counter of opcodes} of the innermost hot
    loop of each function in a ``cuobjdump -sass`` listing: the shortest
    loop (a backward branch) with at least 90% of the most FFMA any loop
    holds (an outer loop that adds a few FFMA of its own, as B2's table
    decode, around the inner one is not it) -- of the most HMMA, in a
    function whose loops hold any (V3's tensor-core loop)."""
    from collections import Counter

    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn = kernel_name(part.split("\n", 1)[0])
        if not fn:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);", part)
        at = {int(a, 16): i for i, (a, _, _) in enumerate(ins)}
        loops = []
        for i, (_, op, args) in enumerate(ins):
            t = re.search(r"0x([0-9a-f]+)", args)
            j = at.get(int(t.group(1), 16)) if t else None
            if not op.startswith("BRA") or j is None or j >= i:
                continue
            loops.append(Counter(o.split(".")[0] for _, o, _ in ins[j: i + 1]))
        if loops:
            op = "HMMA" if any(c["HMMA"] for c in loops) else "FFMA"
            most = max(c[op] for c in loops)
            out[fn] = min((c for c in loops if c[op] >= 0.9 * most),
                          key=lambda c: sum(c.values()))
    return out


# the sources whose every instantiation must spill nothing: production
# B2, B3 and B4, and the redesigned V1-V4
NO_SPILL_SOURCES = ("crossprod_ff_v2.cu", "matvec_v2.cu", "matvec_ff_v2.cu",
                    "crossprod_variants_v2.cu", "crossprod_split3_v2.cu")
# B5's, B4's, B3's, B2's and B1's instruction mix, and V1's, V2's and
# V4's: the FFMA share of their inner loops' instructions, for the
# current designs, B5's other tiles and the first designs (cuobjdump,
# which the CUDA toolkit ships beside nvcc); B1 beside V4 is what the
# compensation costs in instructions.  V3's loop is read by its HMMA:
# its CUDA-core instructions a genotype (split3_ops_per_genotype)
SASS_SOURCES = ("matvec_ff_novl.cu", "matvec_ff_novl_variants.cu",
                "matvec_ff.cu", "matvec_ff_v2.cu", "crossprod_ff_v2.cu",
                "crossprod_ff.cu", "matvec_v2.cu", "matvec.cu",
                "crossprod_v2.cu", "crossprod_variants_v2.cu",
                "crossprod_split3_v2.cu")
# V3's instantiation at the sweep's width on 16-byte aligned rows, whose
# count its sweep row reports beside its bound
SPLIT3_SASS = "split_tile_kernel<16, 1>"
# B1's and V2's loops at the sweep's width: one loop (b1_tile.cuh), the
# decode's form outside it, so the same instructions
SAME_LOOP = ("crossprod_tile_kernel<16>", "intsub_tile_kernel<16>")


def sass_read(fn):
    """Whether the smoke reports the inner-loop mix of instantiation
    ``fn`` (of B2's first design only the production fold, 64 rows a
    chunk)."""
    return (fn.startswith(("matvec_ff", "crossprod_ff", "matvec_tile",
                           "crossprod_tile", "nocomp_tile", "stacked_tile",
                           "intsub_tile", "split_tile"))
            or (fn.startswith("matvec_kernel<") and fn.endswith(", 64>")))


def split3_needed_ops_per_genotype(kc):
    """The CUDA-core instructions a genotype that V3's function needs at
    ``kc`` columns: the pick and the fold (1.875 at kc 16)."""
    return SPLIT3_PICK_OPS + SPLIT3_FOLD_OPS * kc / SPLIT3_FOLD_SAMPLES


def split3_ops_per_genotype(loop, kc):
    """CUDA-core instructions a genotype in V3's inner ``loop`` (a Counter
    of opcodes) at ``kc``: every instruction but its HMMA, over the
    genotypes the loop's HMMA consume -- an m16n8k16 takes 8 genotypes a
    thread, and each feeds 3 kc / 8 of them (three products, kc / 8
    n-tiles)."""
    hmma = loop["HMMA"]
    return (sum(loop.values()) - hmma) / (hmma * 64 / (3 * kc))


def require_same_loop(sass_mix, a, b):
    """Instantiations ``a`` and ``b`` read in ``sass_mix`` have inner
    loops of the same length and FFMA count."""
    keys = ("instructions", "ffma")
    if a not in sass_mix or b not in sass_mix or any(
            sass_mix[a][k] != sass_mix[b][k] for k in keys):
        raise AssertionError(f"{b}'s inner loop is not {a}'s: "
                             f"{sass_mix.get(b)} against {sass_mix.get(a)}")


def require_no_spills(src, usages):
    """Every instantiation in ``usages`` (``ptxas_usage`` pairs) reports
    0 bytes of spill stores and loads."""
    clean = "; 0 bytes spill stores, 0 bytes spill loads"
    bad = [fn for fn, usage in usages if not usage.endswith(clean)]
    if bad or not usages:
        raise AssertionError(f"{src}: spills (or no ptxas report) in {bad}")


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


def cli_in(cdir, args, title):
    """The port's CLI run with ``args`` from the directory ``cdir``
    (where it writes its files) in a Phase called ``title``; returns its
    exit code and what it printed."""
    from flashpca_tpu_torch.cli import main as cli_main

    cwd = os.getcwd()
    os.chdir(cdir)
    buf = io.StringIO()
    try:
        with Phase(title), contextlib.redirect_stdout(buf):
            rc = cli_main(args)
    finally:
        os.chdir(cwd)
    if rc:
        say(buf.getvalue())
    return rc, buf.getvalue()


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


def require_b1_equal(z, z1, where):
    """B1 must give its first design's sums bit for bit."""
    import torch

    if not torch.equal(z, z1):
        raise AssertionError(
            f"crossprod {where}: not bit-equal to crossprod_v1 (max diff "
            f"{float((z - z1).abs().max()):.3e})")


def require_variant_equal(outs, where):
    """V1-V4 must give their first designs' sums bit for bit (``outs``:
    {kernel: result, ...})."""
    import torch

    for first in VARIANT_FIRSTS:
        name = first.removesuffix("_v1")
        z, z1 = outs[name], outs[first]
        if not torch.equal(z, z1):
            raise AssertionError(
                f"{name} {where}: not bit-equal to {first} (max diff "
                f"{float((z - z1).abs().max()):.3e})")


def require_b2_equal(y, y1, y64, where):
    """B2 (``y``) must give its first design's sums (``y1``) bit for bit,
    and so the first design's tile entry at production's 64 rows a chunk
    (``y64``: the same folds)."""
    import torch

    for name, other in (("matvec_v1", y1), ("matvec_tiled cr=64", y64)):
        if not torch.equal(y, other):
            raise AssertionError(
                f"matvec {where}: not bit-equal to {name} (max diff "
                f"{float((y - other).abs().max()):.3e})")


def require_b3_equal(z, z1, where):
    """B3 must give its first design's (z_hi, z_err) bit for bit."""
    import torch

    for half, a, b in (("z_hi", z[0], z1[0]), ("z_err", z[1], z1[1])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"crossprod_ff {where}: {half} not bit-equal to "
                f"crossprod_ff_v1 (max diff {float((a - b).abs().max()):.3e})")


def require_b4_equal(y, y1, where):
    """B4 must give its first design's (y_hi, y_err) bit for bit."""
    import torch

    for half, a, b in (("y_hi", y[0], y1[0]), ("y_err", y[1], y1[1])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"matvec_ff {where}: {half} not bit-equal to matvec_ff_v1 "
                f"(max diff {float((a - b).abs().max()):.3e})")


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
    product, on a full-width slice and a small odd case: B1-B4 and the
    first designs of B1, B2, B3 and B4 (each bit-equal to its production
    kernel), the sweep's V1-V4 (sharing B1's float64 product) and their
    first designs (V1-V4 bit-equal to them), B1's tile entries (bit-equal
    to B1) and B2's (at 64 rows a chunk bit-equal to B2).  Returns
    {kernel: max abs err against the plain version}."""
    import torch

    from flashpca_tpu_torch.kernels import crossprod_variants as cv
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    worst = {name: 0.0 for name in WIDE_PATH + SWEEP_PATH
             + ("crossprod_v1", "matvec_v1", "crossprod_ff_v1",
                "matvec_ff_v1")}
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
            plain_z = tpk.crossprod_plain(packed, mean, invsd, x)
            plain_zz = tpk.crossprod_ff_plain(packed, lut6, x)
            plain_y = tpk.matvec_plain(packed, mean, invsd, v)
            plain_yy = tpk.matvec_ff_plain(packed, lut6, v, vl)
            outs = {
                # name: (kernel result, plain result, float64 product,
                #        plain bar, float64 bar); two-float pairs compare
                #        hi with hi and hi + lo with float64
                "crossprod": (tpk.crossprod_p(packed, mean, invsd, x),
                              plain_z, ref_z, bar_z, 1e-5),
                "crossprod_v1": (tpk.crossprod_v1_p(packed, mean, invsd, x),
                                 plain_z, ref_z, bar_z, 1e-5),
                "matvec": (tpk.matvec_p(packed, mean, invsd, v), plain_y,
                           ref_y, bar_y, 1e-5),
                "matvec_v1": (tpk.matvec_v1_p(packed, mean, invsd, v),
                              plain_y, ref_y, bar_y, 1e-5),
                "crossprod_ff": (tpk.crossprod_ff_p(packed, lut6, x),
                                 plain_zz, ref_z, bar_z, 5e-6),
                "crossprod_ff_v1": (tpk.crossprod_ff_v1_p(packed, lut6, x),
                                    plain_zz, ref_z, bar_z, 5e-6),
                "matvec_ff": (tpk.matvec_ff_p(packed, lut6, v, vl),
                              plain_yy, ref_yy, bar_y, 5e-6),
                "matvec_ff_v1": (tpk.matvec_ff_v1_p(packed, lut6, v, vl),
                                 plain_yy, ref_yy, bar_y, 5e-6),
            }
            for name in VARIANTS + VARIANT_FIRSTS:
                wrapper, plain = (cv.VARIANTS.get(name)
                                  or cv.FIRST_DESIGNS[name])
                outs[name] = (wrapper(packed, mean, invsd, x),
                              plain(packed, mean, invsd, x), ref_z,
                              plain_bar(4 * nb * (
                                  SPLIT3_BF16_DOTS if name.startswith(
                                      "crossprod_split3") else 1)),
                              F64_BAR[name])
            require_b1_equal(outs["crossprod"][0], outs["crossprod_v1"][0],
                             f"{label} k={k}")
            require_variant_equal({name: outs[name][0] for name in VARIANTS
                                   + VARIANT_FIRSTS}, f"{label} k={k}")
            require_b3_equal(outs["crossprod_ff"][0],
                             outs["crossprod_ff_v1"][0], f"{label} k={k}")
            require_b4_equal(outs["matvec_ff"][0], outs["matvec_ff_v1"][0],
                             f"{label} k={k}")
            # the tile entries: B1's bit-equal to production B1 (each
            # thread walks the same chunks whatever the rows per block),
            # B2's against B2's plain version (its fold points move), and
            # at 64 rows a chunk bit-equal to B2 (they do not)
            z = outs["crossprod"][0]
            for tm in cv.TILE_TM:
                zt = cv.crossprod_tiled_p(packed, mean, invsd, x, tm)
                if not torch.equal(zt, z):
                    raise AssertionError(
                        f"crossprod_tiled tm={tm} {label} k={k}: not "
                        f"bit-equal to crossprod_p (max diff "
                        f"{float((zt - z).abs().max()):.3e})")
            for cr in cv.TILE_CR:
                outs[f"matvec_tiled/{cr}"] = (
                    cv.matvec_tiled_p(packed, mean, invsd, v, cr),
                    plain_y, ref_y, bar_y, 1e-5)
            require_b2_equal(outs["matvec"][0], outs["matvec_v1"][0],
                             outs["matvec_tiled/64"][0], f"{label} k={k}")
            errs, rels = {}, {}
            for name, (got, plain, ref, bar, f64_bar) in outs.items():
                errs[name], rels[name] = hold(f"{name} {label} k={k}", got,
                                              plain, ref, bar, f64_bar)
            for name, e in errs.items():
                key = name.split("/")[0]
                worst[key] = max(worst[key], e)
            say(f"   {label} k={k}: max abs err vs plain "
                + ", ".join(f"{n_}={e:.2e}" for n_, e in errs.items())
                + "; kernel vs float64 rel "
                + ", ".join(f"{n_}={e:.1e}" for n_, e in rels.items()))
        del packed, mean, invsd, lut6
    return worst


def check_tall_kernels(dev):
    """B5 and the tall two-float gram against their plain versions and
    against float64 products, on the kernel-check cases and at the tall
    width; there B1, B2 and B3 too, at the tall path's widths, beside the
    first designs of B1, B2, B3 and B4 (each bit-equal to its production
    kernel at every case and k, and B2 to its first design's tile entry
    at 64 rows a chunk).  B5's comparison entries likewise (its first
    design, C = 4 and CR = 128), and the tall gram with the CR = 128
    entry in B5's place against float64, measured but not held to
    GRAM_F64_BAR.  Returns ({name: max
    abs err vs plain}: of the hi half for B5, of the pair's float64 sum
    for CR = 128, the gram and B3; {name: max relative err of the
    kernel vs float64}).

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

    from flashpca_tpu_torch.kernels import crossprod_variants as cv
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import valid_mask_permuted

    worst, f64_rel = {}, {}
    for label, p, n, seed in KERNEL_CASES + (TALL_CASE,):
        packed, mean, invsd, lut6, nb, luts = random_operands(p, n, seed,
                                                              dev)
        valid = valid_mask_permuted(n, nb, torch.float32, dev)
        m = valid[:, None]
        g = torch.Generator(device=dev).manual_seed(seed + 200)
        # k 24 and 28 run B5 at kc 24 and 32, the tall pca()'s widths
        for k in (3, 16, 24, 28):
            v = torch.randn((p, k), generator=g, device=dev)
            ref_y = f64_product(packed, lut6, v, transpose=True)
            my = ref_y * valid.double()[:, None]
            ref_z = f64_product(packed, lut6, my, transpose=False)
            abs_z = f64_product(packed, lut6.abs(), my.abs(),
                                transpose=False)
            plain_y = tpk.matvec_ff_novl_plain(packed, lut6, v)
            # B1 and B3 against their first designs on a draw of their
            # own (the draws below stay those of earlier runs)
            gx = torch.Generator(device=dev).manual_seed(seed + 300 + k)
            xb = torch.randn((4 * nb, k), generator=gx, device=dev)
            require_b1_equal(tpk.crossprod_p(packed, mean, invsd, xb),
                             tpk.crossprod_v1_p(packed, mean, invsd, xb),
                             f"{label} k={k}")
            require_b3_equal(tpk.crossprod_ff_p(packed, lut6, xb),
                             tpk.crossprod_ff_v1_p(packed, lut6, xb),
                             f"{label} k={k}")
            del xb
            # B2 likewise, on v (B2 takes the SNP-space panel), and B4
            # on v and a v_lo of its own draw
            require_b2_equal(tpk.matvec_p(packed, mean, invsd, v),
                             tpk.matvec_v1_p(packed, mean, invsd, v),
                             cv.matvec_tiled_p(packed, mean, invsd, v, 64),
                             f"{label} k={k}")
            gl = torch.Generator(device=dev).manual_seed(seed + 400 + k)
            vl = torch.randn((p, k), generator=gl, device=dev) * 1e-7
            require_b4_equal(tpk.matvec_ff_p(packed, lut6, v, vl),
                             tpk.matvec_ff_v1_p(packed, lut6, v, vl),
                             f"{label} k={k}")
            del vl
            outs = {
                # name: (kernel, plain, float64, plain bar, float64 bar,
                #        compare the pairs' sums (else hi halves))
                "matvec_ff_novl": (
                    tpk.matvec_ff_novl_p(packed, lut6, v), plain_y,
                    ref_y, plain_bar(p), 5e-6, False),
                "matvec_ff_novl_v1": (
                    tpk.matvec_ff_novl_v1_p(packed, lut6, v), plain_y,
                    ref_y, plain_bar(p), 5e-6, False),
                "matvec_ff_novl_c4": (
                    tpk.matvec_ff_novl_c4_p(packed, lut6, v), plain_y,
                    ref_y, plain_bar(p), 5e-6, False),
                # folds every 128 rows: by the pairs' sums
                "matvec_ff_novl_cr128": (
                    tpk.matvec_ff_novl_cr128_p(packed, lut6, v), plain_y,
                    ref_y, plain_bar(p), 5e-6, True),
                "gram_tall_ff": (
                    tpk.gram_tall_ff_p(packed, *luts, mean, invsd, v, valid),
                    tpk.gram_tall_ff_plain(packed, *luts, mean, invsd, v,
                                           valid),
                    ref_z, (2e-5, 4 * EPS32 * abs_z), 5e-6, True),
            }
            # the tall gram with B5 at CR = 128 in B5's place (measured,
            # not held to GRAM_F64_BAR: production folds at 64)
            yh, yl = outs["matvec_ff_novl_cr128"][0]
            zh, zl = tpk.crossprod_ff_p(packed, lut6, yh * m)
            zl = zl + tpk.crossprod_p(packed, mean, invsd, yl * m)
            rel128 = rel_err(zh.double() + zl.double(), ref_z)
            f64_rel["gram_tall_ff_cr128"] = max(
                f64_rel.get("gram_tall_ff_cr128", 0.0), rel128)
            if label == TALL_CASE[0] and k > 3:
                # B1-B3 at the tall width and the tall path's panels (the
                # solver's 16, the polish's nev 28 -> kc 32); B3 by its
                # pairs' sums, as the gram: over 7,840 folds of 128
                # samples the kernel and the plain version leave
                # different shares of a sum in the err half
                x = torch.randn((4 * nb, k), generator=g, device=dev)
                ref_x = f64_product(packed, lut6, x, transpose=False)
                plain_x = tpk.crossprod_plain(packed, mean, invsd, x)
                plain_xx = tpk.crossprod_ff_plain(packed, lut6, x)
                plain_mv = tpk.matvec_plain(packed, mean, invsd, v)
                outs.update({
                    "crossprod": (tpk.crossprod_p(packed, mean, invsd, x),
                                  plain_x, ref_x, plain_bar(4 * nb), 1e-5,
                                  False),
                    "crossprod_v1": (
                        tpk.crossprod_v1_p(packed, mean, invsd, x), plain_x,
                        ref_x, plain_bar(4 * nb), 1e-5, False),
                    "matvec": (tpk.matvec_p(packed, mean, invsd, v),
                               plain_mv, ref_y, plain_bar(p), 1e-5, False),
                    "matvec_v1": (tpk.matvec_v1_p(packed, mean, invsd, v),
                                  plain_mv, ref_y, plain_bar(p), 1e-5, False),
                    "crossprod_ff": (tpk.crossprod_ff_p(packed, lut6, x),
                                     plain_xx, ref_x, plain_bar(4 * nb), 5e-6,
                                     True),
                    "crossprod_ff_v1": (
                        tpk.crossprod_ff_v1_p(packed, lut6, x), plain_xx,
                        ref_x, plain_bar(4 * nb), 5e-6, True),
                })
            if "crossprod" in outs:
                require_b1_equal(outs["crossprod"][0],
                                 outs["crossprod_v1"][0], f"{label} k={k}")
                require_b3_equal(outs["crossprod_ff"][0],
                                 outs["crossprod_ff_v1"][0], f"{label} k={k}")
            msg, rels = [], {}
            for name, (got, plain, ref, bar, f64_bar, sums) in outs.items():
                tag = f"{name} {label} k={k}"
                e, rels[name] = hold(tag, got, plain, ref, bar, f64_bar, sums)
                worst[name] = max(worst.get(name, 0.0), e)
                f64_rel[name] = max(f64_rel.get(name, 0.0), rels[name])
                msg.append(f"{name} {e:.2e} (kernel vs float64 "
                           f"{rels[name]:.1e})")
            # the gram's tight float64 bar, and its control
            rel = rels["gram_tall_ff"]
            ctl = rel_err(tpk.crossprod_p(
                packed, mean, invsd,
                tpk.matvec_p(packed, mean, invsd, v) * valid[:, None]),
                ref_z)
            msg.append(f"gram with B5 at CR=128 vs float64 {rel128:.1e}; "
                       f"plain float32 gram vs float64 {ctl:.1e}")
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
        del packed, mean, invsd, lut6, luts, valid, m
    return worst, f64_rel


# ---------------------------------------------------------------------------
# Phase 4: mid-size PLINK fileset against a float64 oracle
# ---------------------------------------------------------------------------

def write_mid_fileset(workdir, n=8001, p=4096, seed=5):
    """The mid-size PLINK fileset ``workdir/mid``: n samples of 12
    populations of unequal size (which keeps the structured eigenvalues
    apart, so the eigenvectors are well determined), p SNPs, 1% missing
    calls and one constant SNP.  Returns its root."""
    from flashpca_tpu_torch.io.plink import write_bed

    rng = np.random.default_rng(seed)
    pops = 12
    w = 0.8 ** np.arange(pops)
    pop = rng.choice(pops, size=n, p=w / w.sum())
    freq = np.clip(rng.uniform(0.05, 0.5, p)[:, None]
                   + rng.normal(0.0, 0.1, (p, pops)), 0.02, 0.98)
    geno = rng.binomial(2, freq[:, pop].T).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.01] = np.nan
    geno[:, 7] = 1.0                                   # a constant SNP
    root = os.path.join(workdir, "mid")
    write_bed(root, geno)
    return root


def mid_size(dev, workdir, n=8001, p=4096, k=10, seed=5):
    import torch

    from flashpca_tpu_torch import PlinkDataset, check, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    root = write_mid_fileset(workdir, n, p, seed)
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
    rmse = vector_rmse(res.vectors, U_ref)
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

    # the same fileset streamed from its .bed memmap, 1 MB of device
    # block buffers: held to the resident run of this phase
    tpk.reset_launch_counts()
    t0 = time.time()
    res_s = pca(root, k, device=dev, streaming=True, memory_mb=1)
    sync()
    t_stream = time.time() - t0
    chk_s = check(ds, res_s.vectors, res_s.values, device=dev,
                  streaming=True, memory_mb=1)
    launches = dict(tpk.launch_counts)
    rel_s = np.abs(res_s.values - res.values) / res.values
    say(f"   streamed (memory_mb=1): {t_stream:.2f} s, n_ops "
        f"{res_s.n_ops}, gate mse {res_s.gate_mse}, check mse "
        f"{chk_s.mse:.3e}; eigenvalues vs resident rel err max "
        f"{rel_s.max():.2e}")
    require_launched(launches, WIDE_PATH, "mid-size streamed path")
    require_no_first_design(launches, "mid-size streamed path")
    if not rel_s.max() <= 2e-6:
        raise AssertionError(f"mid-size streamed: eigenvalues {rel_s.max():.2e}"
                             " relative off the resident run")
    if not chk_s.mse < 1e-8:
        raise AssertionError(f"mid-size streamed: check mse {chk_s.mse:.3e}")
    f64 = mid_float64(dev, root, ds, k, d_ref, U_ref)
    cli = mid_cli(dev, workdir, root, ds, k, seed)
    scca = mid_scca(dev, workdir, root, ds, seed)
    cv_split = mid_cv_split(dev, root, ds, seed)
    dense = mid_dense(dev, workdir, root, ds, k, d_ref, U_ref)
    return {"n_ops": res.n_ops, "check_mse": chk.mse, "pca_s": t_pca,
            "eig_rel_err": float(rel.max()),
            "eig_err_of_largest": float(rel_norm.max()),
            "vec_rmse": float(rmse.max()),
            "streamed": {"pca_s": t_stream, "n_ops": res_s.n_ops,
                         "gate_mse": res_s.gate_mse, "check_mse": chk_s.mse,
                         "eig_rel_err_vs_resident": float(rel_s.max()),
                         "launches": {nm: launches[nm] for nm in WIDE_PATH}},
            "float64": f64, "cli": cli, "dense": dense, "scca": scca,
            "cv_split": cv_split}


def vector_rmse(U, U_ref):
    """Per column sign-invariant RMSE of ``U`` against ``U_ref``."""
    return np.array([min(np.linalg.norm(U[:, j] - U_ref[:, j]),
                         np.linalg.norm(U[:, j] + U_ref[:, j]))
                     for j in range(U_ref.shape[1])]) / np.sqrt(len(U))


def mid_float64(dev, root, ds, k, d_ref, U_ref):
    """float64 on the card: the mid-size fileset's wide and tall
    ``pca()`` through the functional core, held to the dense float64
    eigendecomposition (eigenvalues within F64_EIG_BAR of the largest,
    vectors RMSE < F64_VEC_RMSE), ``check()`` at float64 (mse < 1e-8),
    and the wide run streamed from the .bed memmap (``memory_mb=1``)
    within 1e-12 relative of the resident one; no kernel may launch."""
    import torch

    from flashpca_tpu_torch import check, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    f64 = torch.float64
    out = {}
    tpk.reset_launch_counts()
    runs = {}
    for mode, kw in (("wide", {}), ("tall", {"operator_mode": "tall"}),
                     ("streamed", {"streaming": True, "memory_mb": 1})):
        with Phase(f"mid-size pca float64 on the card, {mode}") as ph:
            runs[mode] = pca(root, k, device=dev, dtype=f64, **kw)
        out[mode] = {"pca_s": ph.seconds, "n_ops": runs[mode].n_ops,
                     "n_restarts": runs[mode].n_restarts}
    with Phase("mid-size check() float64 on the card") as ph:
        chk = check(ds, runs["wide"].vectors, runs["wide"].values,
                    device=dev, dtype=f64)
    launches = dict(tpk.launch_counts)
    out.update(check_mse=chk.mse, check_s=ph.seconds,
               launches=sum(launches.values()))
    for mode in ("wide", "tall"):
        r = runs[mode]
        err = np.abs(r.values - d_ref) / d_ref[0]
        rmse = vector_rmse(r.vectors, U_ref)
        out[mode].update(eig_err_of_largest=float(err.max()),
                         vec_rmse=float(rmse.max()))
        say(f"   float64 {mode}: n_ops {r.n_ops}, n_restarts "
            f"{r.n_restarts}, vs float64 eigh: eigenvalues "
            f"{err.max():.2e} of the largest, vector RMSE {rmse.max():.2e}")
        if not (err.max() < F64_EIG_BAR and rmse.max() < F64_VEC_RMSE):
            raise AssertionError(
                f"mid-size float64 {mode}: eigenvalues {err.max():.2e} of "
                f"the largest (bar {F64_EIG_BAR}), vector RMSE "
                f"{rmse.max():.2e} (bar {F64_VEC_RMSE}) off float64 eigh")
    rel_s = np.abs(runs["streamed"].values - runs["wide"].values) / np.abs(
        runs["wide"].values)
    out["streamed"]["eig_rel_err_vs_resident"] = float(rel_s.max())
    say(f"   float64 streamed: n_ops {runs['streamed'].n_ops}, eigenvalues "
        f"vs resident rel {rel_s.max():.2e}; check mse {chk.mse!r}; kernel "
        f"launches {sum(launches.values())}")
    if not rel_s.max() <= 1e-12:
        raise AssertionError(f"mid-size float64 streamed: eigenvalues "
                             f"{rel_s.max():.2e} relative off the resident "
                             "float64 run")
    if not chk.mse < 1e-8:
        raise AssertionError(f"mid-size float64: check mse {chk.mse:.3e}")
    ran = [nm for nm, c in launches.items() if c]
    if ran:
        raise AssertionError(f"float64 on the card launched kernels {ran}: "
                             "it runs the functional core")
    return out


def mid_dense(dev, workdir, root, ds, k, d_ref, U_ref):
    """The mid-size fileset as a numeric matrix and through mid-run
    checkpoints: ``pca(ds.read_matrix(impute_mean=False))`` (missing
    calls NaN, mean-imputed by the standardization) at float32 and at
    float64 on the card, and ``flashpca()`` on the same matrix, each held
    to the dense float64 eigh (float32: eigenvalues within 1e-6 of the
    largest, vectors RMSE < 1e-5, check mse < 1e-8 on the matrix,
    through a float64 DenseOperator on the card;
    float64: F64_EIG_BAR and F64_VEC_RMSE); no kernel may launch on the
    dense operator.  The CLI's ``--batch`` pca, then ``--check`` (mse <
    1e-8).  Then ``pca(root, 2 k, checkpoint_every=1)`` at float64 with
    tol 1e-10 (pairs in the Marchenko-Pastur bulk: a solve of many
    restarts on any card, where the float32 contract path may stop after
    one): its first mid-run .npz (marked not converged) resumes with
    ``state_in`` to eigenvalues within 1e-6 of the largest of the
    checkpointed run's."""
    import shutil

    import torch

    import flashpca_tpu_torch.solvers.lanczos as lz
    from flashpca_tpu_torch import flashpca, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.models.check import check

    out = {}
    X = ds.read_matrix(impute_mean=False)
    tpk.reset_launch_counts()
    runs = {}
    for tag, run in (("float32", lambda: pca(X, k, device=dev)),
                     ("float64", lambda: pca(X, k, device=dev,
                                             dtype=torch.float64)),
                     ("flashpca", lambda: flashpca(X, k, device=dev))):
        with Phase(f"mid-size pca on the numeric matrix, {tag}") as ph:
            runs[tag] = run()
        r = runs[tag]
        err = np.abs(r.values - d_ref) / d_ref[0]
        rmse = vector_rmse(r.vectors, U_ref)
        chk = check(X, r.vectors, r.values, device=dev)
        out[tag] = {"pca_s": ph.seconds, "n_ops": r.n_ops,
                    "eig_err_of_largest": float(err.max()),
                    "vec_rmse": float(rmse.max()), "check_mse": chk.mse}
        say(f"   {tag}: n_ops {r.n_ops}, vs float64 eigh: eigenvalues "
            f"{err.max():.2e} of the largest, vector RMSE {rmse.max():.2e},"
            f" check mse {chk.mse:.3e}")
        bars = ((F64_EIG_BAR, F64_VEC_RMSE) if tag == "float64"
                else (1e-6, 1e-5))
        if not (err.max() < bars[0] and rmse.max() < bars[1]
                and chk.mse < 1e-8):
            raise AssertionError(
                f"mid-size dense {tag}: eigenvalues {err.max():.2e} of the "
                f"largest, vector RMSE {rmse.max():.2e} (bars {bars}), "
                f"check mse {chk.mse:.3e}")
    ran = [nm for nm, c in tpk.launch_counts.items() if c]
    if ran:
        raise AssertionError(f"the dense operator launched kernels {ran}")

    cdir = os.path.join(workdir, "cli_batch")
    os.makedirs(cdir)
    args = ["--bfile", root, "--notime", "--device", dev.type,
            "--ndim", str(k)]
    rc, _ = cli_in(cdir, args + ["--batch"], "CLI --batch")
    rc_check, printed = cli_in(cdir, args + ["--check"], "CLI --check")
    line = [ln for ln in printed.splitlines()
            if "Mean squared error" in ln]
    if rc or rc_check or not line:
        raise AssertionError(f"CLI --batch exited {rc}, --check {rc_check}")
    mse = float(line[0].split("Mean squared error: ")[1].split(",")[0])
    say(f"   --batch then --check: mse {mse!r}")
    if not mse < 1e-8:
        raise AssertionError(f"CLI --batch: check mse {mse:.3e}")
    out["cli_batch_check_mse"] = mse

    state = os.path.join(workdir, "ck.npz")
    mid = os.path.join(workdir, "mid.npz")
    writes = []
    save_state = lz.save_state

    def spy(path, vectors, values, residuals, converged):
        save_state(path, vectors, values, residuals, converged)
        writes.append(bool(converged))
        if not converged and not os.path.exists(mid):
            shutil.copy(path, mid)

    ck_kw = dict(device=dev, dtype=torch.float64, tol=1e-10)
    lz.save_state = spy
    try:
        with Phase(f"mid-size pca(k={2 * k}) float64, checkpoint_every=1"
                   ) as ph:
            ck = pca(root, 2 * k, state_out=state, checkpoint_every=1,
                     **ck_kw)
    finally:
        lz.save_state = save_state
    with Phase("mid-size pca resumed from its first mid-run checkpoint"):
        warm = pca(root, 2 * k, state_in=mid, **ck_kw)
    err = np.abs(warm.values - ck.values) / ck.values[0]
    say(f"   {writes.count(False)} mid-run checkpoints, then "
        f"{writes.count(True)} final write(s); resumed: n_ops {warm.n_ops}, "
        f"n_restarts {warm.n_restarts} (checkpointed run {ck.n_ops}, "
        f"{ck.n_restarts}), eigenvalues {err.max():.2e} of "
        "the largest off the checkpointed run's")
    if not (writes and not writes[0] and writes[-1] and os.path.exists(mid)):
        raise AssertionError(f"checkpoint_every=1: writes {writes}")
    if not err.max() < 1e-6:
        raise AssertionError(f"resumed from a mid-run checkpoint: "
                             f"eigenvalues {err.max():.2e} of the largest")
    out["checkpoint"] = {"pca_s": ph.seconds, "mid_run_writes":
                         writes.count(False), "n_restarts": ck.n_restarts,
                         "resumed_n_restarts": warm.n_restarts,
                         "resumed_n_ops": warm.n_ops,
                         "eig_err_of_largest": float(err.max())}
    return out


def column_rel_err(got, ref):
    """Per column ||got - ref|| / ||ref||."""
    return np.linalg.norm(got - ref, axis=0) / np.linalg.norm(ref, axis=0)


def hold_projection(tag, got, ref, npop):
    """Hold a projection to its reference: the first ``npop`` columns
    (the population PCs) each within PROJECT_BAR of its own norm, every
    column within PROJECT_BAR of the largest column's norm.  Returns the
    per column errors, relative to each column's own norm."""
    err = column_rel_err(got, ref)
    norms = np.linalg.norm(ref, axis=0)
    of_largest = err * norms / norms.max()
    say(f"   {tag}: column rel err " + " ".join(f"{e:.1e}" for e in err)
        + f"; of the largest column {of_largest.max():.2e}")
    if not (got.shape == ref.shape and np.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite or misshapen")
    if not (err[:npop].max() < PROJECT_BAR
            and of_largest.max() < PROJECT_BAR):
        raise AssertionError(
            f"{tag}: population columns {err[:npop].max():.2e} relative "
            f"off the reference, columns {of_largest.max():.2e} of the "
            f"largest (bar {PROJECT_BAR} each)")
    return err


def hold_ucca(tag, got, ref):
    """Hold a (p, 3) ucca result [R, F, P] to its float64 oracle: R
    within UCCA_R_BAR relative, F within UCCA_F_BAR, -log10 P within
    UCCA_LOGP_BAR absolute.  A SNP whose standardized genotypes are all
    0 (monomorphic, or all heterozygous under binom2) is the oracle's
    0/0, nan; float32 decode constants leave it ~1e-8 off 0, so there
    the result must be nan or show no association (P > 0.5).  Returns
    the three errors."""
    flat = np.isnan(ref[:, 0])
    if np.isnan(got[~flat]).any() or not np.all(np.isnan(got[flat, 2])
                                                | (got[flat, 2] > 0.5)):
        raise AssertionError(f"{tag}: nan off the oracle's constant SNPs, "
                             "or an association at one of them")
    ok = ~flat
    g, r = got[ok], ref[ok]
    errs = (float(np.max(np.abs(g[:, 0] - r[:, 0]) / r[:, 0])),
            float(np.max(np.abs(g[:, 1] - r[:, 1]) / r[:, 1])),
            float(np.max(np.abs(np.log10(g[:, 2]) - np.log10(r[:, 2])))))
    say(f"   {tag}: R rel {errs[0]:.2e}, F rel {errs[1]:.2e}, -log10 P "
        f"abs {errs[2]:.2e} over {int(ok.sum())} SNPs")
    if not (errs[0] <= UCCA_R_BAR and errs[1] <= UCCA_F_BAR
            and errs[2] <= UCCA_LOGP_BAR):
        raise AssertionError(
            f"{tag}: off the float64 oracle (R {errs[0]:.2e} bar "
            f"{UCCA_R_BAR}, F {errs[1]:.2e} bar {UCCA_F_BAR}, -log10 P "
            f"{errs[2]:.2e} bar {UCCA_LOGP_BAR})")
    return errs


def ucca_from_products(out, sumsq, Y, stand_y="sd"):
    """[R, F, P] per SNP from the crossprod of [Y_c, 1] (``out``, float64
    (p, k + 1)) and the per-SNP sums of squares: the host half of
    ``ucca()``, which the oracles share with it."""
    from flashpca_tpu_torch.models.ucca import _r2_from_moments, wilks
    from flashpca_tpu_torch.ops.standardize import standardize

    Y_std = standardize(Y, stand_y)[0]
    n, k = Y_std.shape
    _, sv, Vt = np.linalg.svd(Y_std, full_matrices=False)
    varx = (sumsq - out[:, k] ** 2 / n) / (n - 1.0)
    return wilks(_r2_from_moments(out[:, :k] / (n - 1.0), varx, sv, Vt.T,
                                  n), n, k)


def centred_panel(Y, stand_y="sd"):
    """[Y_c, 1]: the standardized phenotypes, centred, and a column of
    ones, the panel ``ucca()`` sends through one crossprod."""
    from flashpca_tpu_torch.ops.standardize import standardize

    Y_std = standardize(Y, stand_y)[0]
    Yc = Y_std - Y_std.mean(axis=0, keepdims=True)
    return np.concatenate([Yc, np.ones((len(Y), 1))], axis=1)


def mid_cli(dev, workdir, root, ds, k, seed, n_pheno=3):
    """The CLI on ``dev`` (float32 on the card): ``pca`` writes its
    loadings and meansd, ``--project --inload --inmeansd`` reads them
    back, and ``--ucca --pheno`` a phenotype file written here (noise
    plus the effects of ``n_pheno`` SNPs); each held to a numpy float64
    oracle on the dense standardized matrix, the projection by
    :func:`hold_projection`, ucca by :func:`hold_ucca`.  B2 must launch
    for --project and B1 for --ucca."""
    from flashpca_tpu_torch.io.text import read_text
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    cdir = os.path.join(workdir, "cli")
    os.makedirs(cdir)

    def run(*args):
        tpk.reset_launch_counts()
        rc, _ = cli_in(cdir, ["--bfile", root, "--notime", "--device",
                              dev.type, *args], "CLI " + " ".join(args))
        if rc != 0:
            raise AssertionError(f"CLI {args} exited {rc}")
        return dict(tpk.launch_counts)

    def path(fn):
        return os.path.join(cdir, fn)

    n, p = ds.n_samples, ds.n_snps
    # pca under --profile: its Chrome trace must name B1's and B2's
    # kernels among its CUDA kernel events
    run("--ndim", str(k), "--outload", "loadings.txt", "--outmeansd",
        "meansd.txt", "--profile", "prof")
    profiled = profile_kernels(path("prof"), cuda=dev.type == "cuda")
    proj_launches = run("--project", "--inload", "loadings.txt",
                        "--inmeansd", "meansd.txt")
    V = read_text(path("loadings.txt"), firstcol=3, skip=1)
    ms = read_text(path("meansd.txt"), firstcol=3, skip=1)
    Px = read_text(path("projection.txt"), firstcol=3, skip=1)
    codes = ds.read_codes()
    X = dense_standardized_np(codes, ms[:, 0], ms[:, 1]).T    # (n, p)
    say(f"   --project: B2 launches {proj_launches['matvec']}")
    require_launched(proj_launches, PROJECT_PATH, "CLI --project")
    # the fileset's 12 populations: all k <= 11 PCs are population PCs
    proj_err = hold_projection("--project vs numpy float64", Px,
                               X @ V / np.sqrt(p), npop=k)

    rng = np.random.default_rng(seed + 1)
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    X = dense_standardized_np(codes, mean, sd).T
    causal = rng.choice(p, size=n_pheno, replace=False)
    Y = rng.standard_normal((n, n_pheno)) + 0.15 * X[:, causal]
    fam = [f + "\t" + i for f, i in zip(ds.fam_ids, ds.indiv_ids)]
    with open(path("pheno.txt"), "w") as fh:
        for ids, row in zip(fam, Y):
            fh.write(ids + "\t" + "\t".join(f"{v:.17g}" for v in row)
                     + "\n")
    ucca_launches = run("--ucca", "--pheno", "pheno.txt")
    got = read_text(path("ucca.txt"), firstcol=2, skip=1)
    ref = ucca_from_products(X.T @ centred_panel(Y), sumsq, Y)
    say(f"   --ucca: B1 launches {ucca_launches['crossprod']}; causal SNPs "
        f"{sorted(causal.tolist())} at P {got[np.sort(causal), 2]}")
    require_launched(ucca_launches, UCCA_PATH, "CLI --ucca")
    errs = hold_ucca("--ucca vs numpy float64", got, ref)
    # --ucca --batch: the numeric-matrix path, standardized on the host
    # and held by a float64 DenseOperator on the card
    run("--ucca", "--batch", "--pheno", "pheno.txt")
    batch = read_text(path("ucca.txt"), firstcol=2, skip=1)
    batch_errs = hold_ucca("--ucca vs --ucca --batch", got, batch)
    return {"project_col_rel_err": float(proj_err.max()),
            "ucca_errs": errs, "ucca_vs_batch_errs": batch_errs,
            "profile": profiled,
            "launches": {"project": proj_launches["matvec"],
                         "ucca": ucca_launches["crossprod"]}}


# the CUDA kernel names of B1 and B2 (crossprod_v2.cu, matvec_v2.cu) as a
# profiler trace shows them
PROFILE_KERNELS = {"crossprod": "crossprod_tile_kernel",
                   "matvec": "matvec_tile_kernel"}


def profile_kernels(prof_dir, cuda=True):
    """The CLI's ``--profile`` trace in ``prof_dir``: one Chrome trace
    file whose CUDA kernel events name B1 and B2 (PROFILE_KERNELS); a
    run on the CPU (the phase rehearsed) has no CUDA events, and its
    trace must hold operator events instead.  Returns {kernel: events,
    ...} with the file's size."""
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"--profile wrote {files} into {prof_dir}")
    fn = os.path.join(prof_dir, files[0])
    with open(fn) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [str(e.get("name", "")) for e in events
            if e.get("cat") == "kernel"]
    found = {k: sum(sym in nm for nm in kern)
             for k, sym in PROFILE_KERNELS.items()}
    say(f"   --profile: {files[0]} ({os.path.getsize(fn) / 1e6:.1f} MB), "
        f"{len(kern)} CUDA kernel events; B1/B2 events {found}")
    if not cuda:
        if not any(e.get("cat") == "cpu_op" for e in events):
            raise AssertionError("--profile trace holds no operator event")
    elif not all(found.values()):
        raise AssertionError(f"--profile trace names no CUDA kernel event "
                             f"of {[k for k, c in found.items() if not c]}")
    return {"kernel_events": len(kern), "bytes": os.path.getsize(fn),
            **found}


def mid_phenotypes(ds, seed, n_pheno=5):
    """``n_pheno`` standard normal phenotypes of the mid-size fileset
    from ``default_rng(seed + 2)``, the first two each carrying the
    summed standardized genotypes of 20 SNPs at 0.05."""
    from flashpca_tpu_torch.ops.genotypes import dense_standardized_np

    n, p = ds.n_samples, ds.n_snps
    rng = np.random.default_rng(seed + 2)
    mean, sd = ds.snp_stats("binom2")
    X = dense_standardized_np(ds.read_codes(), mean, sd).T
    support = rng.choice(p, size=(2, 20), replace=False)
    Y = rng.standard_normal((n, n_pheno))
    Y[:, :2] += 0.05 * np.stack([X[:, s].sum(axis=1) for s in support], 1)
    return Y


def mid_scca(dev, workdir, root, ds, seed, n_pheno=5, ndim=2):
    """SCCA on the mid-size fileset: ``n_pheno`` phenotypes, two of them
    carrying 20 SNPs' effects each, penalties SCCA_L1 / sqrt(p) and
    SCCA_L2.  ``scca`` on ``dev`` at its default dtype (float32 on the
    card: B1 and B2 must launch) held to the same call at float64 on
    ``dev`` with the same V0 (the functional core, no launch), and the
    same call streamed (``streaming=True, memory_mb=1``, the host
    engine) held to it too: d within SCCA_F32_D_BAR relative, U and V
    within SCCA_F32_UV_BAR, all at tol SCCA_MID_TOL.  Then the CLI's
    ``--scca`` on ``dev``, its files held to a ``--dtype float64`` run
    (pcsX / pcsY columns within SCCA_F32_PC_BAR of their norms), and
    ``--outstate`` cut after dimension 1 and resumed with ``--instate``:
    the same files byte for byte as the uninterrupted run."""
    import torch

    from flashpca_tpu_torch import load_scca_state, scca
    from flashpca_tpu_torch.io.text import read_text
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.models.scca import make_gaussian

    n, p = ds.n_samples, ds.n_snps
    Y = mid_phenotypes(ds, seed, n_pheno)
    lam = (SCCA_L1 / np.sqrt(p), SCCA_L2)
    kw = dict(ndim=ndim, maxiter=500, tol=SCCA_MID_TOL, device=dev,
              V0=make_gaussian(n_pheno, ndim, seed))
    out = {}
    tpk.reset_launch_counts()
    with Phase("mid-size scca, default dtype") as ph:
        r32 = scca(root, Y, *lam, **kw)
    launches = dict(tpk.launch_counts)
    out["s"] = ph.seconds
    tpk.reset_launch_counts()
    with Phase("mid-size scca, float64"):
        r64 = scca(root, Y, *lam, dtype=torch.float64, **kw)
    launches64 = sum(tpk.launch_counts.values())
    with Phase("mid-size scca streamed, memory_mb=1"):
        rs = scca(root, Y, *lam, streaming=True, memory_mb=1, **kw)

    def off(a, b):
        return (float((np.abs(a.d - b.d) / np.abs(b.d)).max()),
                max(float(np.abs(a.U - b.U).max()),
                    float(np.abs(a.V - b.V).max())))

    out.update(d=r32.d.tolist(), iters=r32.n_iters.tolist(),
               launches={nm: launches[nm] for nm in SCCA_PATH + SCCA_PX},
               vs_float64=off(r32, r64), streamed_vs_float64=off(rs, r64),
               float64_launches=launches64)
    say(f"   d {r32.d}, iterations {r32.n_iters.tolist()} (float64: "
        f"{r64.n_iters.tolist()}); {scca_launch_text(launches)}; vs "
        f"float64 d rel, U/V abs "
        f"{out['vs_float64']}, streamed {out['streamed_vs_float64']}")
    if dev.type == "cuda":
        require_launched(launches, SCCA_PATH + SCCA_PX, "mid-size scca")
    if launches64:
        raise AssertionError(f"mid-size scca at float64: {launches64} "
                             "kernel launches")
    for tag, (e_d, e_uv) in (("float32", out["vs_float64"]),
                             ("streamed", out["streamed_vs_float64"])):
        if not (r32.converged and r64.converged and rs.converged
                and e_d <= SCCA_F32_D_BAR and e_uv <= SCCA_F32_UV_BAR):
            raise AssertionError(f"mid-size scca {tag} vs float64: d rel "
                                 f"{e_d:.2e}, U/V {e_uv:.2e}")

    cdir = os.path.join(workdir, "scca_cli")
    os.makedirs(cdir)
    fam = [f + "\t" + i for f, i in zip(ds.fam_ids, ds.indiv_ids)]
    pheno = os.path.join(cdir, "pheno.txt")
    with open(pheno, "w") as fh:
        for ids, row in zip(fam, Y):
            fh.write(ids + "\t" + "\t".join(f"{v:.17g}" for v in row)
                     + "\n")
    files = ("eigenvalues.txt", "eigenvectorsX.txt", "eigenvectorsY.txt",
             "pcsX.txt", "pcsY.txt")

    def run(sub, *args):
        d = os.path.join(cdir, sub)
        os.makedirs(d)
        rc, _ = cli_in(d, ["--bfile", root, "--scca", "--pheno", pheno,
                           "--ndim", str(ndim), "--lambda1",
                           repr(float(lam[0])), "--lambda2", repr(lam[1]),
                           "--tol", repr(SCCA_MID_TOL), "--notime",
                           "--device", dev.type, *args],
                       f"CLI --scca {' '.join(args)}")
        if rc != 0:
            raise AssertionError(f"CLI --scca {args} exited {rc}")
        return d

    def read(d, fn):
        return np.atleast_2d(np.loadtxt(os.path.join(d, fn)))

    state = os.path.join(cdir, "state.npz")
    a = run("card", "--outstate", state)
    b = run("float64", "--dtype", "float64")
    d_rel = np.abs(read(a, files[0]) - read(b, files[0])) / np.abs(
        read(b, files[0]))
    uv = max(float(np.abs(read(a, fn) - read(b, fn)).max())
             for fn in files[1:3])
    pc = max(float((np.linalg.norm(read(a, fn) - read(b, fn), axis=0)
                    / np.linalg.norm(read(b, fn), axis=0)).max())
             for fn in files[3:])
    st = load_scca_state(state)
    st.update(next_dim=np.asarray(1),
              d=np.concatenate([st["d"][:1], np.zeros(ndim - 1)]))
    st["U"][:, 1:] = 0.0
    st["V"][:, 1:] = st["V0"][:, 1:]
    cut = os.path.join(cdir, "cut.npz")
    np.savez(cut, **st)
    c = run("resumed", "--instate", cut)
    def raw(d, fn):
        with open(os.path.join(d, fn), "rb") as fh:
            return fh.read()

    same = all(raw(a, fn) == raw(c, fn) for fn in files)
    out["cli"] = {"d_rel_vs_float64": float(d_rel.max()),
                  "uv_abs_vs_float64": uv, "pc_col_rel_vs_float64": pc,
                  "resumed_equal": same}
    say(f"   --scca vs --dtype float64: d rel {d_rel.max():.2e}, U/V abs "
        f"{uv:.2e}, pcsX/pcsY column rel {pc:.2e}; --instate after "
        f"dimension 1 byte-equal to the uninterrupted run: {same}")
    if not (d_rel.max() <= SCCA_F32_D_BAR and uv <= SCCA_F32_UV_BAR
            and pc <= SCCA_F32_PC_BAR):
        raise AssertionError(f"CLI --scca vs --dtype float64: {out['cli']}")
    if not same:
        raise AssertionError("CLI --scca --instate: not the uninterrupted "
                             "run's files")
    return out


# ---------------------------------------------------------------------------
# Penalty selection: cv_scca and split_scca
# ---------------------------------------------------------------------------

class CallClock:
    """Wraps the functions ``(module, name, label)`` of ``targets`` for
    the duration of a ``with`` block: each call is timed between two
    synchronizations and logged with its result as (label, seconds,
    result), in call order; the positional arguments of the first call
    of each label in ``keep`` are kept in ``first_args``."""

    def __init__(self, targets, keep=()):
        self.targets = targets
        self.keep = keep
        self.calls = []
        self.first_args = {}

    def __enter__(self):
        self.saved = []
        for mod, name, label in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _label=label, **k):
                if _label in self.keep:
                    self.first_args.setdefault(_label, a)
                sync()
                t0 = time.time()
                out = _fn(*a, **k)
                sync()
                self.calls.append((_label, time.time() - t0, out))
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def results(self, label):
        return [out for lab, _, out in self.calls if lab == label]

    def seconds(self, label):
        return [t for lab, t, _ in self.calls if lab == label]


def search_fields(res):
    """The correlation arrays of a penalty search: a SplitSCCAResult's
    test and train, or a CVSCCAResult's pooled ones."""
    if hasattr(res, "corr_test"):
        return {"corr_test": res.corr_test, "corr_train": res.corr_train}
    return {"corr": res.corr}


def hold_search(tag, got, ref):
    """Hold the penalty search ``got`` (a CVSCCAResult or
    SplitSCCAResult) to ``ref`` on the same grid: the converged flags
    equal, the correlations within CV_CORR_BAR where both are finite
    (and finite in the same cells), the best cell the same unless the
    reference's correlation there is within CV_TIE_BAR of its best, and
    in every cell that converged throughout the non-zero counts within
    CV_NZ_SHARE of the reference's.  Returns the worst of each."""
    if not np.array_equal(got.converged, ref.converged):
        raise AssertionError(f"{tag}: converged {got.converged.tolist()} "
                             f"vs {ref.converged.tolist()}")
    corr = 0.0
    for key, a in search_fields(got).items():
        b = getattr(ref, key)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            raise AssertionError(f"{tag}: {key} finite in other cells")
        both = np.isfinite(a)
        if both.any():
            corr = max(corr, float(np.abs(a[both] - b[both]).max()))
    sl = search_fields(ref)["corr_test" if hasattr(ref, "corr_test")
                            else "corr"][ref.opt_dim - 1]
    i = int(np.flatnonzero(ref.lambda1 == got.best_lambda1)[0])
    j = int(np.flatnonzero(ref.lambda2 == got.best_lambda2)[0])
    tie = float(ref.best_corr - sl[i, j])
    conv = (got.converged if got.converged.ndim == 2
            else got.converged.all(axis=0))
    share = 0.0
    for a, b in ((got.nzero_x, ref.nzero_x), (got.nzero_y, ref.nzero_y)):
        a, b = a[:, conv], b[:, conv]
        off = np.abs(a - b)
        if (off > CV_NZ_SHARE * b).any():
            raise AssertionError(f"{tag}: non-zeros {a.tolist()} vs "
                                 f"{b.tolist()}")
        if off.size:
            share = max(share, float((off / np.maximum(b, 1)).max()))
    out = {"corr_abs": corr, "best_tie": tie, "nz_share": share,
           "best": [got.best_lambda1, got.best_lambda2, got.best_corr]}
    say(f"   {tag}: correlations max abs {corr:.2e} (bar {CV_CORR_BAR}); "
        f"best (lambda1 {got.best_lambda1:.4g}, lambda2 "
        f"{got.best_lambda2:g}) corr {got.best_corr:.6f}, the reference's "
        f"best {ref.best_corr:.6f} there {sl[i, j]:.6f}; non-zeros off by "
        f"{share:.2%} at most")
    if corr > CV_CORR_BAR or tie > CV_TIE_BAR:
        raise AssertionError(f"{tag}: {out}")
    return out


def mid_cv_split(dev, root, ds, seed, ndim=2):
    """Penalty selection on the mid-size fileset, its phenotypes
    :func:`mid_phenotypes` and the CV_MID_L1 x CV_MID_L2 grid (lambda1
    in units of 1 / sqrt(p)): ``cv_scca(root, ...)`` with 5 folds and
    ``init=True`` and ``split_scca(root, ...)`` at CV_PROP_TRAIN, each on
    ``dev`` at its default dtype (float32 on the card: B1 and B2 must
    launch), held (:func:`hold_search`) to the same call at float64 on
    ``dev`` (the functional core: no launch) and to the sequential
    fallback (``engine="host"``); ``cv_scca`` streamed (``streaming=True,
    memory_mb=1``) held to the resident run, and on the fileset's
    numeric matrix (a DenseOperator a fold, no launch) at float32 held
    to its float64 default."""
    import torch

    from flashpca_tpu_torch import cv_scca, split_scca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    p = ds.n_snps
    Y = mid_phenotypes(ds, seed)
    l1 = np.array(CV_MID_L1) / np.sqrt(p)
    l2 = np.array(CV_MID_L2)
    kw = dict(ndim=ndim, maxiter=500, tol=SCCA_MID_TOL, device=dev)
    runs = {}

    def run(tag, fn, X, **extra):
        tpk.reset_launch_counts()
        with Phase(f"mid-size {tag}") as ph:
            res = fn(X, Y, l1, l2, **kw, **extra)
        runs[tag] = {"s": ph.seconds, "launches": dict(tpk.launch_counts)}
        return res

    f64 = torch.float64
    cv = dict(nfolds=5, init=True)
    sp = dict(prop_train=CV_PROP_TRAIN)
    c32 = run("cv_scca", cv_scca, root, **cv)
    c64 = run("cv_scca float64", cv_scca, root, dtype=f64, **cv)
    ch = run("cv_scca engine=host", cv_scca, root, engine="host", **cv)
    cs = run("cv_scca streamed memory_mb=1", cv_scca, root, streaming=True,
             memory_mb=1, **cv)
    X = ds.read_matrix()
    cm32 = run("cv_scca numeric matrix float32", cv_scca, X,
               dtype=torch.float32, **cv)
    cm64 = run("cv_scca numeric matrix", cv_scca, X, **cv)
    del X
    s32 = run("split_scca", split_scca, root, **sp)
    s64 = run("split_scca float64", split_scca, root, dtype=f64, **sp)
    sh = run("split_scca engine=host", split_scca, root, engine="host",
             **sp)
    # the grid engines run their cells' panel; the sequential fallback
    # (engine="host") solo fits, one column each
    for tag, path in (("cv_scca", SCCA_GRID_PATH),
                      ("split_scca", SCCA_GRID_PATH),
                      ("cv_scca engine=host", SCCA_PATH),
                      ("split_scca engine=host", SCCA_PATH),
                      ("cv_scca streamed memory_mb=1", SCCA_GRID_PATH)):
        if dev.type == "cuda":
            require_launched(runs[tag]["launches"], path, f"mid-size {tag}")
        require_no_first_design(runs[tag]["launches"], f"mid-size {tag}")
    for tag in ("cv_scca float64", "split_scca float64",
                "cv_scca numeric matrix float32", "cv_scca numeric matrix"):
        if sum(runs[tag]["launches"].values()):
            raise AssertionError(f"mid-size {tag}: kernel launches "
                                 f"{runs[tag]['launches']}")
    for res in (c64, ch, cs, cm32, cm64):
        if not np.array_equal(res.folds, c32.folds):
            raise AssertionError("mid-size cv_scca: the folds differ")
    holds = {
        "cv_vs_float64": hold_search("cv_scca vs float64", c32, c64),
        "cv_vs_host": hold_search("cv_scca vs engine=host", c32, ch),
        "cv_streamed_vs_resident": hold_search(
            "cv_scca streamed vs resident", cs, c32),
        "cv_matrix_vs_float64": hold_search(
            "cv_scca numeric matrix float32 vs float64", cm32, cm64),
        "split_vs_float64": hold_search("split_scca vs float64", s32, s64),
        "split_vs_host": hold_search("split_scca vs engine=host", s32, sh),
    }
    say(f"   folds {np.bincount(c32.folds).tolist()}; split train "
        f"{len(s32.train_idx)}, test {len(s32.test_idx)}; B1/B2 launches "
        + ", ".join(f"{tag} {r['launches']['crossprod']}/"
                    f"{r['launches']['matvec']}" for tag, r in runs.items()))
    return {"runs": runs, "holds": holds,
            "cv_best": [c32.best_lambda1, c32.best_lambda2, c32.best_corr],
            "split_best": [s32.best_lambda1, s32.best_lambda2,
                           s32.best_corr]}


# ---------------------------------------------------------------------------
# Streaming: the wide operator with its bytes on the host
# ---------------------------------------------------------------------------

# streamed same-order cases (label, SNPs, samples, seed, block geometry):
# a full-width slice in eleven blocks of 409 rows at memory_mb=98 (the
# last block 6 rows), and a small odd case (nb % 16 != 0) in nine blocks
STREAM_CASES = (("full width 4096 x 501760", 4096, 501_760, 24,
                 {"memory_mb": 98}),
                ("odd 333 x 1001", 333, 1001, 25, {"block_snps": 40}))
# the staging configurations each case runs: (prefetch, blocks cached)
STREAM_CONFIGS = ((True, 0), (False, 0), (True, 3))
# the streamed headline: the reference's "2GB" (flashpca README)
STREAM_MEMORY_MB = 2048


def same_order_streamed(op, P, seed):
    """Three back-to-back products of each kind through the streaming
    operator ``op``, with no synchronisation between them -- the plain
    gram at kc 16, ``crossprod``, ``prod`` and the two-float gram at kc
    24 -- each ``torch.equal`` to the same blocks' products summed in the
    same order from the row slices of ``P``, the same bytes held whole
    (the plain gram as B2 of B1 per block, the two-float one as the
    TwoSum fold of B3 then B4 per block); on the card ``crossprod`` also
    to B1 on all of ``P``.  Returns the number of products checked."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.compensated import twosum
    from flashpca_tpu_torch.ops.genotypes import (permute_samples,
                                                  unpermute_samples)

    dev = P.device
    m, iv = op.mean, op.invsd
    lh, ll = op._ff_luts()
    v = op._valid[:, None]
    rows = [op._bounds(i) for i in range(op.n_blocks)]
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(r, k):
        return [torch.randn((r, k), generator=g, device=dev) for _ in range(3)]

    ins = {"gram": draw(op.n4, 16), "crossprod": draw(op.n_samples, 16),
           "prod": draw(op.n_snps, 16), "gram_ff": draw(op.n4, 24)}
    # the products, back to back
    outs = {"gram": [op.gram_permuted(x) for x in ins["gram"]],
            "crossprod": [op.crossprod(x) for x in ins["crossprod"]],
            "prod": [op.prod(w) for w in ins["prod"]],
            "gram_ff": [op.gram_ff_permuted(x) for x in ins["gram_ff"]]}

    def gram(x):
        x = x * v
        acc = torch.zeros_like(x)
        for lo, hi in rows:
            z = tpk.crossprod_p(P[lo:hi], m[lo:hi], iv[lo:hi], x)
            acc = acc + tpk.matvec_p(P[lo:hi], m[lo:hi], iv[lo:hi], z)
        return acc * v

    def cross(x):
        xp = permute_samples(x, op.nbytes) * v
        return (torch.cat([tpk.crossprod_p(P[lo:hi], m[lo:hi], iv[lo:hi], xp)
                           for lo, hi in rows]),
                tpk.crossprod_p(P, m, iv, xp))

    def prod(w):
        acc = torch.zeros((op.n4, w.shape[1]), device=dev)
        for lo, hi in rows:
            acc = acc + tpk.matvec_p(P[lo:hi], m[lo:hi], iv[lo:hi], w[lo:hi])
        return unpermute_samples(acc * v, op.n_samples)

    def gram_ff(x):
        x = x * v
        y_hi, y_err = torch.zeros_like(x), torch.zeros_like(x)
        for lo, hi in rows:
            t_hi, t_err = tpk.gram_ff_p(P[lo:hi], lh[lo:hi], ll[lo:hi], x)
            y_hi, e = twosum(y_hi, t_hi)
            y_err = y_err + e + t_err
        return y_hi * v, y_err * v

    def require_equal(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(
                f"streamed {what}: not bit-equal to its same-order "
                f"reference (max diff {float((got - want).abs().max()):.3e})")

    for i in range(3):
        require_equal(f"gram #{i}", outs["gram"][i], gram(ins["gram"][i]))
        blocks, whole = cross(ins["crossprod"][i])
        require_equal(f"crossprod #{i}", outs["crossprod"][i], blocks)
        if dev.type == "cuda":
            # B1's row sums do not depend on the rows around them (the
            # plain version's byte chunks do: they follow the row count)
            require_equal(f"crossprod #{i} (resident B1)",
                          outs["crossprod"][i], whole)
        require_equal(f"prod #{i}", outs["prod"][i], prod(ins["prod"][i]))
        for half, a, b in zip(("y_hi", "y_err"), outs["gram_ff"][i],
                              gram_ff(ins["gram_ff"][i])):
            require_equal(f"gram_ff #{i} {half}", a, b)
    return 3 * len(outs)


def check_streamed(dev, cases=STREAM_CASES, **op_kw):
    """Smoke phase: for each case, the bytes generated on the card, copied
    to the host and streamed back by a StreamingPackedOperator in each
    staging configuration (prefetch on and off with no block cached, and
    three blocks cached), every product bit-equal to its same-order
    reference (:func:`same_order_streamed`); the blocks staged and the
    device bytes held as the configuration says.  ``op_kw`` goes to the
    operators (a CPU rehearsal passes float32 and ``use_kernels=True``,
    whose plain versions stand in for the kernels).  Returns a
    summary."""
    import torch

    from flashpca_tpu_torch import StreamingPackedOperator
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    out = {}
    for label, p, n, seed, geometry in cases:
        packed, mean, sd, _ = card_data(dev, n, p, seed)
        host = packed.cpu().numpy()
        for prefetch, n_cached in STREAM_CONFIGS:
            op = StreamingPackedOperator(host, mean, sd, n, device=dev,
                                         cache_mb=0, prefetch=prefetch,
                                         **geometry, **op_kw)
            op._n_cached = n_cached
            tpk.reset_launch_counts()
            products = same_order_streamed(op, packed, seed + 100)
            launches = dict(tpk.launch_counts)
            st = op.stats()
            # every product (and no reference) staged the uncached blocks
            want = op.n_blocks + (products - 1) * (op.n_blocks - n_cached)
            bound = (2 + n_cached) * st["block_bytes"]
            say(f"   {label}, prefetch {prefetch}, {n_cached} cached: "
                f"{op.n_blocks} blocks of {op.block_snps} rows, {products} "
                f"products bit-equal; staged {st['staged_host_blocks']} "
                f"blocks, device bytes {st['device_bytes']}, fill "
                f"{st['fill_s']:.3f} s, wait {st['wait_s']:.3f} s")
            if st["staged_host_blocks"] != want or st["nops"] != products:
                raise AssertionError(
                    f"streamed {label}: staged {st['staged_host_blocks']} "
                    f"blocks in {st['nops']} products, not {want} in "
                    f"{products}")
            if dev.type == "cuda" and not 0 < st["device_bytes"] <= bound:
                raise AssertionError(
                    f"streamed {label}: {st['device_bytes']} device bytes, "
                    f"bound {bound}")
            require_launched(launches, WIDE_PATH, f"streamed {label}")
            require_no_first_design(launches, f"streamed {label}")
            op.close()
            out[f"{label}/{int(prefetch)}/{n_cached}"] = {
                "n_blocks": op.n_blocks, "block_snps": op.block_snps,
                "products": products, **st}
        del packed, host
    return out


# streamed tall same-order cases (label, SNPs, samples, seed, block
# geometry, read from a .bed memmap): a slice of the tall headline's
# width in its twelve blocks of 21,396 bytes (the last 15,524), a small
# odd case (n % 4 == 1) in five blocks of 60 bytes (the last 11), and a
# case read from a .bed written here (n % 4 == 3), eleven blocks of
# 1,000 bytes, the last 1, so the strided column read runs on the card
TALL_STREAM_CASES = (("tall width 2048 x 1003520", 2048, 1_003_520, 26,
                      {"block_bytes": 21_396}, False),
                     ("odd 333 x 1001", 333, 1001, 27, {"block_bytes": 60},
                      False),
                     (".bed memmap 1024 x 40003", 1024, 40_003, 28,
                      {"block_bytes": 1000}, True))
# the panel widths of the tall products: the solver's and the polish's
TALL_STREAM_KCS = (16, 32)


def write_packed_fileset(root, packed, n):
    """A PLINK fileset holding the (p, nbytes) bytes ``packed`` as they
    are (the .bed's SNP-major payload), with placeholder .bim and .fam
    rows."""
    from flashpca_tpu_torch.io.plink import BED_MAGIC

    with open(root + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(np.ascontiguousarray(packed).tobytes())
    with open(root + ".bim", "w") as fh:
        fh.writelines(f"1\tsnp{j}\t0\t{j + 1}\tA\tC\n"
                      for j in range(packed.shape[0]))
    with open(root + ".fam", "w") as fh:
        fh.writelines(f"id{i}\tid{i}\t0\t0\t0\t-9\n" for i in range(n))


def same_order_tall_streamed(op, P, seed, kcs=TALL_STREAM_KCS):
    """Two back-to-back products of each kind and panel width in ``kcs``
    through the tall streaming operator ``op``, with no synchronisation
    between them -- the plain gram, the two-float gram and ``prod`` --
    each ``torch.equal`` to the same blocks' kernel calls summed in block
    order, the blocks cut from ``P``, the same bytes held whole (the
    plain gram as B1 of the masked B2 per block, the two-float one as
    the TwoSum fold of the tall two-float gram per block, ``prod`` as
    each block's masked B2 un-permuted into its run of samples).  The
    masks are built here from the sample count.  Returns the number of
    products checked."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.compensated import twosum
    from flashpca_tpu_torch.ops.genotypes import unpermute_samples

    dev, n = P.device, op.n_samples
    m, iv = op.mean, op.invsd
    lh, ll = op._ff_luts()
    blocks = []
    for i in range(op.n_blocks):
        lo, hi = op._bounds(i)
        sample = (4 * torch.arange(lo, hi, device=dev)[None, :]
                  + torch.arange(4, device=dev)[:, None])
        blocks.append((P[:, lo:hi].contiguous(),
                       (sample < n).to(torch.float32).reshape(-1), lo, hi))
    g = torch.Generator(device=dev).manual_seed(seed)
    ins = {(kind, kc): [torch.randn((op.n_snps, kc), generator=g,
                                    device=dev) for _ in range(2)]
           for kind in ("gram", "gram_ff", "prod") for kc in kcs}
    run = {"gram": op.gram_permuted, "gram_ff": op.gram_ff_permuted,
           "prod": op.prod}
    # the products, back to back
    outs = {key: [run[key[0]](x) for x in xs] for key, xs in ins.items()}

    def gram(v):
        acc = torch.zeros_like(v)
        for blk, va, _, _ in blocks:
            y = tpk.matvec_p(blk, m, iv, v) * va[:, None]
            acc = acc + tpk.crossprod_p(blk, m, iv, y)
        return acc

    def gram_ff(v):
        z_hi, z_err = torch.zeros_like(v), torch.zeros_like(v)
        for blk, va, _, _ in blocks:
            t_hi, t_err = tpk.gram_tall_ff_p(blk, lh, ll, m, iv, v, va)
            z_hi, e = twosum(z_hi, t_hi)
            z_err = z_err + e + t_err
        return z_hi, z_err

    def prod(v):
        return torch.cat([unpermute_samples(
            tpk.matvec_p(blk, m, iv, v) * va[:, None], 4 * (hi - lo))
            for blk, va, lo, hi in blocks])[:n]

    ref = {"gram": gram, "gram_ff": gram_ff, "prod": prod}
    for (kind, kc), xs in ins.items():
        for i, x in enumerate(xs):
            got, want = outs[kind, kc][i], ref[kind](x)
            if kind != "gram_ff":
                got, want = (got,), (want,)
            for half, a, b in zip(("", " hi", " lo"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"tall streamed {kind}{half} kc={kc} #{i}: not "
                        "bit-equal to its same-order reference (max diff "
                        f"{float((a - b).abs().max()):.3e})")
    return sum(len(xs) for xs in ins.values())


def check_tall_streamed(dev, workdir, cases=TALL_STREAM_CASES, **op_kw):
    """Smoke phase: for each case, the bytes generated on the card, copied
    to the host (or written to a .bed and read through its memmap) and
    streamed back by a TallStreamingOperator in each staging
    configuration of STREAM_CONFIGS, every product bit-equal to its
    same-order reference (:func:`same_order_tall_streamed`); the blocks
    staged and the device bytes held as the configuration says.
    ``op_kw`` as :func:`check_streamed`.  Returns a summary."""
    import torch

    from flashpca_tpu_torch import PlinkDataset, TallStreamingOperator
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    out = {}
    for label, p, n, seed, geometry, memmap in cases:
        packed, mean, sd, _ = card_data(dev, n, p, seed)
        source = packed.cpu().numpy()
        if memmap:
            root = os.path.join(workdir, f"tall{seed}")
            write_packed_fileset(root, source, n)
            source = PlinkDataset.open(root)
        for prefetch, n_cached in STREAM_CONFIGS:
            op = TallStreamingOperator(source, mean, sd, n, device=dev,
                                       cache_mb=0, prefetch=prefetch,
                                       **geometry, **op_kw)
            op._n_cached = n_cached
            tpk.reset_launch_counts()
            products = same_order_tall_streamed(op, packed, seed + 100)
            launches = dict(tpk.launch_counts)
            st = op.stats()
            want = op.n_blocks + (products - 1) * (op.n_blocks - n_cached)
            bound = (2 + n_cached) * st["block_bytes"]
            last = op.nbytes - op._bounds(op.n_blocks - 1)[0]
            say(f"   {label}, prefetch {prefetch}, {n_cached} cached: "
                f"{op.n_blocks} blocks of {op.block_bytes} bytes (the last "
                f"{last}), {products} products bit-equal; staged "
                f"{st['staged_host_blocks']} blocks, device bytes "
                f"{st['device_bytes']}, fill {st['fill_s']:.3f} s "
                f"({st['staged_bytes'] / max(st['fill_s'], 1e-9) / 1e9:.2f}"
                f" GB/s), wait {st['wait_s']:.3f} s")
            if st["staged_host_blocks"] != want or st["nops"] != products:
                raise AssertionError(
                    f"tall streamed {label}: staged "
                    f"{st['staged_host_blocks']} blocks in {st['nops']} "
                    f"products, not {want} in {products}")
            if dev.type == "cuda" and not 0 < st["device_bytes"] <= bound:
                raise AssertionError(
                    f"tall streamed {label}: {st['device_bytes']} device "
                    f"bytes, bound {bound}")
            require_launched(launches, TALL_PATH, f"tall streamed {label}")
            require_no_first_design(launches, f"tall streamed {label}")
            op.close()
            out[f"{label}/{int(prefetch)}/{n_cached}"] = {
                "n_blocks": op.n_blocks, "block_bytes": op.block_bytes,
                "last_block_bytes": last, "memmap": memmap,
                "products": products, **st}
        del packed, source
    return out


# ---------------------------------------------------------------------------
# Phase 5: the headline
# ---------------------------------------------------------------------------

def generate_headline(n, p, seed, dev, pops=POPS, rows=1024):
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


def scca_launch_text(launches):
    """An SCCA run's B1/B2 launch counts: on one column (the one-column
    kernels: a solo fit's steps) and at kc 8-32 (a solo fit's Px = X U
    on its ndim columns; a grid's panels)."""
    return (f"B1/B2 launches {launches['crossprod_narrow']}/"
            f"{launches['matvec_narrow']} on one column, "
            f"{launches['crossprod']}/{launches['matvec']} at kc 8-32")


def require_no_first_design(launches, what):
    """No path takes a kept first design: it is timed, never launched."""
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    ran = [nm for nm in tpk.VARIANT_FIRST_KERNELS + tpk.B1_KERNELS
           + tpk.B2_KERNELS + tpk.B3_KERNELS + tpk.B4_KERNELS
           + tpk.NOVL_KERNELS if launches[nm]]
    if ran:
        raise AssertionError(f"comparison entries launched on the {what}: "
                             f"{ran}")


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
        f"mse {res.gate_mse!r} (accepts < 7e-9), check mse {chk.mse!r}, "
        f"converged {res.converged}")
    say(f"   pca wall {out['pca_s']:.2f} s, check wall {out['check_s']:.2f} s,"
        f" peak device memory {out['peak_gb']:.2f} GB")
    launch_ms = launch_medians(log)
    require_launched(launches, WIDE_PATH, "wide path")
    require_no_first_design(launches, "wide path")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and np.isfinite(res.values).all()):
        raise AssertionError("headline: non-finite or misshapen result")
    if not chk.mse < 1e-8:
        raise AssertionError(f"headline: check mse {chk.mse:.3e} >= 1e-8")
    if res.n_ops != 20:
        raise AssertionError(f"headline: n_ops {res.n_ops}, not 20")
    # the witness beside the streamed headline's twin bar: the same
    # resident solve from another start seed, against this one
    with Phase(f"pca(op, {k}) from start seed {WITNESS_SEED}"):
        alt = pca(op, k, seed=WITNESS_SEED)
    cos, held, clusters = twin_cosines(alt.vectors, res.vectors, res.values,
                                       TWIN_NEAR * res.values[0])
    say(f"   start seed {WITNESS_SEED} vs 1, |cos| of the twins: "
        + " ".join(f"{c:.8f}" for c in cos))
    say(f"   pairs closer than {TWIN_NEAR} of the largest: {clusters}; "
        "their spans' smallest principal cosine: "
        + " ".join(f"{c:.8f}" for c in held))
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               gate_mse=res.gate_mse, check_mse=chk.mse,
               launches=launches, launch_ms=launch_ms,
               seed_witness={"seed": WITNESS_SEED, "n_ops": alt.n_ops,
                             "abs_cos": cos.tolist(), "held": held.tolist(),
                             "clusters": clusters})
    return op, out, res


def causal_phenotypes(op, k, seed):
    """Phenotypes for ``ucca()`` at the headline: (n, k) seeded normal
    noise plus UCCA_BETA times one SNP's standardized genotypes in each
    column, the k causal SNPs drawn in a window of UCCA_SLICE SNPs and
    decoded on the card from the resident operator's bytes.  Returns (Y,
    the window as a slice, the causal SNPs)."""
    import torch

    from flashpca_tpu_torch.ops.genotypes import (decode_standardized,
                                                  unpermute_samples)
    from flashpca_tpu_torch.utils.device import host64

    span = UCCA_SLICE
    rng = np.random.default_rng(seed)
    s0 = int(rng.integers(0, op.n_snps - span + 1))
    causal = np.sort(s0 + rng.choice(span, size=k, replace=False))
    idx = torch.as_tensor(causal, device=op.device)
    g = decode_standardized(op.packed[idx], op.mean[idx], op.invsd[idx],
                            torch.float64)                      # (k, n4)
    g = host64(unpermute_samples(g.T, op.n_samples))            # (n, k)
    Y = rng.standard_normal((op.n_samples, k)) + UCCA_BETA * g
    return Y, slice(s0, s0 + span), causal


def headline_loadings(op, res):
    """The headline's SNP loadings, as ``pca(do_loadings=True)`` forms
    them: one crossprod of its vectors (B1), scaled by 1 / sqrt(d) /
    sqrt(p)."""
    from flashpca_tpu_torch.utils.device import host64

    Vt = host64(op.crossprod(res.vectors))
    return Vt * (1.0 / np.sqrt(res.values) / np.sqrt(op.n_snps))[None, :]


def project_ucca(op, res, seed=13):
    """``project`` and ``ucca`` at the wide headline, each one pass of
    the resident operator, counts set to 0 just before and read just
    after each.  ``_project_operator(op, V, p)`` with the headline's own
    loadings (:func:`headline_loadings`, one extra B1 launch, counted
    apart), B2 at kc 24, held to the float64 W^T V over all SNPs
    divided by sqrt(p) (:func:`hold_projection`); the
    population PCs of this self-projection against ``res.projection``
    at |cos| >= 1 - 1e-6 (the bulk columns printed, not held).  Then
    ``ucca(op, Y)`` with UCCA_K phenotypes (:func:`causal_phenotypes`):
    one crossprod of UCCA_K + 1 columns, B1 at kc 8, held on the causal
    SNPs' 512-SNP window to the float64 crossprod's R, F and P
    (:func:`hold_ucca`); the causal SNPs must reach P < 1e-8.  Returns
    (the inputs and results the streamed twins are held to, a
    summary)."""
    import torch

    from flashpca_tpu_torch import ucca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.models.project import _project_operator
    from flashpca_tpu_torch.ops.genotypes import (permute_samples,
                                                  unpermute_samples)
    from flashpca_tpu_torch.utils.device import host64

    dev, n, p = op.device, op.n_samples, op.n_snps
    k = res.vectors.shape[1]
    lut6 = tpk.lut_rows(*op._ff_luts())
    out = {}
    tpk.reset_launch_counts()
    with Phase("headline loadings: one crossprod of the vectors") as ph:
        V = headline_loadings(op, res)
    out["loadings"] = {"s": ph.seconds,
                       "launches": tpk.launch_counts["crossprod"]}
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"_project_operator(op, V, p), k={k}") as ph:
            Px = _project_operator(op, V, p)
    proj_launches = dict(tpk.launch_counts)
    out["project"] = {"s": ph.seconds, "launches": proj_launches["matvec"],
                      "launch_ms": launch_medians(log)}
    with Phase("project reference: float64 W^T V over all SNPs"):
        ref = host64(unpermute_samples(
            f64_product(op.packed, lut6, torch.as_tensor(V, device=dev),
                        transpose=True), n)) / np.sqrt(p)
    npop = POPS - 1                   # the population PCs lead
    say(f"   project: B2 launches {proj_launches['matvec']}, loadings' B1 "
        f"launches {out['loadings']['launches']}")
    require_launched(proj_launches, PROJECT_PATH, "headline project")
    require_no_first_design(proj_launches, "headline project")
    err = hold_projection("project vs float64", Px, ref, npop)
    cos = np.abs(np.sum(Px * res.projection, axis=0)
                 / (np.linalg.norm(Px, axis=0)
                    * np.linalg.norm(res.projection, axis=0)))
    say(f"   self-projection |cos| with res.projection, {npop} population "
        "PCs held: " + " ".join(f"{c:.8f}" for c in cos[:npop])
        + "; bulk, not held: " + " ".join(f"{c:.4f}" for c in cos[npop:]))
    out["project"].update(col_rel_err=float(err.max()),
                          pop_min_abs_cos=float(cos[:npop].min()),
                          bulk_abs_cos=cos[npop:].tolist())
    if not cos[:npop].min() >= 1 - 1e-6:
        raise AssertionError(f"headline project: population PCs at |cos| "
                             f"{cos[:npop]} with res.projection")

    Y, window, causal = causal_phenotypes(op, UCCA_K, seed)
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"ucca(op, Y), {UCCA_K} phenotypes") as ph:
            u = ucca(op, Y)
    ucca_launches = dict(tpk.launch_counts)
    out["ucca"] = {"s": ph.seconds, "launches": ucca_launches["crossprod"],
                   "launch_ms": launch_medians(log),
                   "window": [window.start, window.stop],
                   "causal": causal.tolist()}
    with Phase(f"ucca reference: float64 crossprod on a {UCCA_SLICE}-SNP "
               "window"):
        x = permute_samples(torch.as_tensor(centred_panel(Y), device=dev),
                            op.nbytes)
        prods = host64(f64_product(op.packed[window], lut6[:, window], x,
                                   transpose=False))
    ref_u = ucca_from_products(prods, op.snp_sumsq[window], Y)
    say(f"   ucca: B1 launches {ucca_launches['crossprod']}; causal SNPs "
        f"{causal.tolist()} at P " + " ".join(
            f"{x:.2e}" for x in u.pval[causal]))
    require_launched(ucca_launches, UCCA_PATH, "headline ucca")
    require_no_first_design(ucca_launches, "headline ucca")
    out["ucca"]["errs"] = hold_ucca("headline ucca vs float64",
                                    u.result[window], ref_u)
    out["ucca"]["causal_p"] = u.pval[causal].tolist()
    if not (u.result.shape == (p, 3) and np.all(u.pval[causal] < 1e-8)):
        raise AssertionError(f"headline ucca: causal SNPs at P "
                             f"{u.pval[causal]} (must be < 1e-8)")
    return {"V": V, "Px": Px, "Y": Y, "ucca": u.result}, out


def scca_phenotypes(op, rng):
    """SCCA_K phenotypes for the headline SCCA, as the JAX package's
    sparse-SCCA bench builds them: SCCA_NDIM unit directions of
    SCCA_PLANT SNPs each (drawn from ``rng``), their X u* in one prod
    pass (B2), added to the first SCCA_NDIM standard normal columns at
    3 / std.  Returns (Y, the planted supports)."""
    from flashpca_tpu_torch.utils.device import host64

    p, n = op.n_snps, op.n_samples
    Ustar = np.zeros((p, SCCA_NDIM))
    supports = []
    for j in range(SCCA_NDIM):
        idx = rng.choice(p, size=SCCA_PLANT, replace=False)
        Ustar[idx, j] = rng.normal(size=SCCA_PLANT)
        Ustar[:, j] /= np.linalg.norm(Ustar[:, j])
        supports.append(np.sort(idx))
    Xu = host64(op.prod(Ustar))
    Y = rng.standard_normal((n, SCCA_K))
    Y[:, :SCCA_NDIM] += Xu * (3.0 / Xu.std(axis=0, keepdims=True))
    return Y, supports


def scca_fixed_point(op, Y, res, lam1, lam2):
    """One SCCA iteration redone in float64 from the result ``res`` of
    ``scca(op, Y, lam1, lam2)`` (divisor "p"): a float64 PackedOperator
    on the same bytes (the functional core, no kernel) takes one
    crossprod of the Y v_j and one prod of the u_j; each u_j' is
    X^T Y v_j orthogonalized against the earlier u and thresholded, each
    v_j' likewise from Y^T X u_j, and d_j' = (X u_j)^T (Y v_j).  Returns
    per dimension (max |u' - u|, max |v' - v|, |d' - d| / |d'|)."""
    import torch

    from flashpca_tpu_torch import PackedOperator
    from flashpca_tpu_torch.models.scca import _gram_schmidt, norm_thresh
    from flashpca_tpu_torch.ops.standardize import standardize
    from flashpca_tpu_torch.utils.device import host64

    op64 = PackedOperator(op.packed, op.center, op.scale, op.n_samples,
                          device=op.device, dtype=torch.float64,
                          block_size=512)
    Y_std = standardize(Y, "sd")[0]
    Z = host64(op64.crossprod(Y_std @ res.V))
    XU = host64(op64.prod(res.U))
    del op64
    du, dv, dd = [], [], []
    for j in range(res.U.shape[1]):
        u1 = norm_thresh(_gram_schmidt(Z[:, j], res.U, j), lam1)
        v1 = norm_thresh(_gram_schmidt(Y_std.T @ XU[:, j], res.V, j), lam2)
        d1 = XU[:, j] @ (Y_std @ res.V[:, j])
        du.append(float(np.abs(u1 - res.U[:, j]).max()))
        dv.append(float(np.abs(v1 - res.V[:, j]).max()))
        dd.append(float(abs(d1 - res.d[j]) / abs(d1)))
    return du, dv, dd


def busy_and_span(log):
    """(seconds the launches of a ``time_launches`` log ran, seconds from
    the first one's start to the last one's end); (0, 0) when nothing
    launched (the CPU)."""
    if not log:
        return 0.0, 0.0
    busy = sum(a.elapsed_time(b) for _, _, a, b in log) / 1e3
    return busy, log[0][2].elapsed_time(log[-1][3]) / 1e3


def scca_headline(op, seed=SCCA_SEED):
    """SCCA at the wide headline, on its resident float32 operator:
    ``scca(op, Y, SCCA_L1 / sqrt(p), SCCA_L2)`` with SCCA_NDIM
    dimensions (:func:`scca_phenotypes`), counts set to 0 just before
    and read just after (B1 and B2 must launch on one column, through
    their one-column kernels, and B2 at kc 8 for Px), held to converge with every d > 0 and finite Px / Py, and to
    its float64 fixed point (:func:`scca_fixed_point`: u and v within
    SCCA_FIXED_BAR, d within SCCA_D_BAR); each dimension's nonzeros and
    overlap with the planted supports printed; the wall, iterations, and
    per iteration the kernels' time and the rest of the span from the
    first launch to the last (the loop's host work and syncs; CUDA
    events), the wall outside that span printed apart (set-up: Y
    standardized and copied to the card; the result's transfers).  Then
    ``scca_grid`` over the 4 x 4 penalty grid (C = 16: B1 and B2 at kc
    16), its cell SCCA_GRID_CELL held to the solo run; and the solo
    run's streamed twin's resident reference (SCCA_TWIN_ITERS iterations
    at tol 0, one dimension).  Returns (the inputs and results the
    streamed phase holds to, a summary)."""
    from flashpca_tpu_torch import scca, scca_grid
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    p = op.n_snps
    rng = np.random.default_rng(seed)
    with Phase(f"SCCA phenotypes: {SCCA_NDIM} planted {SCCA_PLANT}-SNP "
               "directions, one prod pass"):
        Y, supports = scca_phenotypes(op, rng)
    lam1 = SCCA_L1 / np.sqrt(p)
    kw = dict(ndim=SCCA_NDIM, maxiter=SCCA_MAXITER, tol=SCCA_TOL,
              seed=SCCA_V0_SEED)
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"scca(op, Y), {SCCA_K} phenotypes, ndim {SCCA_NDIM}, "
                   f"lambda1 {lam1:.3e}, lambda2 {SCCA_L2}") as ph:
            res = scca(op, Y, lam1, SCCA_L2, **kw)
    launches = dict(tpk.launch_counts)
    wall = ph.seconds
    kern_s, span_s = busy_and_span(log)
    kcs = sorted({kc for _, kc, _, _ in log})
    iters = res.n_iters.tolist()
    its = max(1, sum(iters))
    launch_ms = launch_medians(log)
    nz = [int(np.count_nonzero(res.U[:, j])) for j in range(SCCA_NDIM)]
    overlap = [[int(np.count_nonzero(res.U[s, j])) for s in supports]
               for j in range(SCCA_NDIM)]
    say(f"   converged {res.converged}, d " + " ".join(
        f"{x:.6f}" for x in res.d) + f"; iterations per dimension {iters}")
    say(f"   U nonzeros {nz} of {p}; per dimension, nonzeros on each "
        f"planted {SCCA_PLANT}-SNP support: {overlap}; V nonzeros "
        f"{[int(np.count_nonzero(res.V[:, j])) for j in range(SCCA_NDIM)]}")
    say(f"   wall {wall:.2f} s; {scca_launch_text(launches)} (kc "
        f"{kcs}), busy {kern_s:.3f} s of the "
        f"{span_s:.3f} s from the first launch to the last: per iteration "
        f"(of {its}; d and Px included) kernels {kern_s / its * 1e3:.2f} ms"
        f", the rest {(span_s - kern_s) / its * 1e3:.2f} ms; outside the "
        f"span {wall - span_s:.3f} s")
    require_launched(launches, SCCA_PATH + SCCA_PX, "headline scca")
    require_no_first_design(launches, "headline scca")
    if not (res.converged and np.all(res.d > 0)
            and np.isfinite(res.Px).all() and np.isfinite(res.Py).all()):
        raise AssertionError(f"headline scca: converged {res.converged}, d "
                             f"{res.d}, Px/Py finite "
                             f"{np.isfinite(res.Px).all()}/"
                             f"{np.isfinite(res.Py).all()}")
    with Phase("SCCA float64 fixed point: one float64 crossprod and prod"):
        du, dv, dd = scca_fixed_point(op, Y, res, lam1, SCCA_L2)
    say("   one float64 iteration from the result: max |du| " + " ".join(
        f"{x:.2e}" for x in du) + ", max |dv| " + " ".join(
        f"{x:.2e}" for x in dv) + f" (bar {SCCA_FIXED_BAR}); d rel "
        + " ".join(f"{x:.2e}" for x in dd) + f" (bar {SCCA_D_BAR})")
    if not (max(du + dv) <= SCCA_FIXED_BAR and max(dd) <= SCCA_D_BAR):
        raise AssertionError("headline scca: not at its float64 fixed "
                             f"point (du {du}, dv {dv}, d {dd})")
    out = {"s": wall, "d": res.d.tolist(), "iters": iters, "nonzeros": nz,
           "support_overlap": overlap, "launches": launches,
           "launch_ms": launch_ms, "kcs": kcs, "kernel_s": kern_s,
           "span_s": span_s, "kernel_ms_per_iter": kern_s / its * 1e3,
           "host_ms_per_iter": (span_s - kern_s) / its * 1e3,
           "outside_span_s": wall - span_s,
           "fixed_point": {"du": du, "dv": dv, "d_rel": dd}}

    l1 = np.array(SCCA_GRID_L1) / np.sqrt(p)
    l2 = np.array(SCCA_GRID_L2)
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"scca_grid(op, Y), {len(l1)} x {len(l2)} cells") as ph:
            g = scca_grid(op, Y, l1, l2, **kw)
    glaunches = dict(tpk.launch_counts)
    gkern_s, gspan_s = busy_and_span(log)
    gkcs = sorted({kc for _, kc, _, _ in log})
    git = max(1, int(g.n_iters.max(axis=1).sum()))
    c = SCCA_GRID_CELL
    d_rel = np.abs(g.d[:, c] - res.d) / np.abs(res.d)
    uv = max(float(np.abs(g.U[:, :, c] - res.U).max()),
             float(np.abs(g.V[:, :, c] - res.V).max()))
    it_off = np.abs(g.n_iters[:, c] - res.n_iters)
    say(f"   grid wall {ph.seconds:.2f} s beside 16 x the solo wall "
        f"{16 * wall:.2f} s; B1/B2 launches {glaunches['crossprod']}/"
        f"{glaunches['matvec']} at kc {gkcs}, busy {gkern_s:.3f} s of the "
        f"{gspan_s:.3f} s launch span: per iteration (of {git}) kernels "
        f"{gkern_s / git * 1e3:.2f} ms, the rest "
        f"{(gspan_s - gkern_s) / git * 1e3:.2f} ms; converged cells "
        f"{int(g.converged.sum())} of {len(g.converged)}")
    say("   iterations per dimension and cell: " + "; ".join(
        " ".join(str(x) for x in row) for row in g.n_iters))
    say(f"   cell {c} (lambda1 {g.lambda1[c]:.3e}, lambda2 "
        f"{g.lambda2[c]}) vs the solo run: d rel " + " ".join(
            f"{x:.2e}" for x in d_rel) + f", U/V max abs {uv:.2e}, "
        f"iterations {g.n_iters[:, c].tolist()} vs {iters}")
    require_launched(glaunches, SCCA_GRID_PATH, "headline scca_grid")
    require_no_first_design(glaunches, "headline scca_grid")
    if not (g.lambda1[c] == lam1 and g.lambda2[c] == SCCA_L2
            and g.converged[c] and d_rel.max() <= SCCA_GRID_D_BAR
            and uv <= SCCA_GRID_UV_BAR and it_off.max() <= SCCA_GRID_ITERS):
        raise AssertionError(
            f"headline scca_grid: cell {c} off the solo run (d rel "
            f"{d_rel}, U/V {uv:.2e}, iterations {g.n_iters[:, c]} vs "
            f"{iters}, converged {g.converged[c]})")
    out["grid"] = {"s": ph.seconds, "solo_x16_s": 16 * wall,
                   "launches": glaunches, "kcs": gkcs, "kernel_s": gkern_s,
                   "span_s": gspan_s, "iters": git,
                   "n_iters": g.n_iters.tolist(),
                   "converged": g.converged.tolist(),
                   "cell_d_rel": d_rel.tolist(), "cell_uv_abs": uv}

    with Phase(f"scca(op, Y), ndim 1, {SCCA_TWIN_ITERS} iterations at tol "
               "0: the streamed twin's reference"):
        twin = scca(op, Y, lam1, SCCA_L2, ndim=1, maxiter=SCCA_TWIN_ITERS,
                    tol=0.0, seed=SCCA_V0_SEED)
    return {"Y": Y, "lam1": lam1, "twin": twin}, out


def cv_phase_snps(per_snp_s, p):
    """D for :func:`headline_cv_split`: the largest multiple of
    CV_PROBE_SNPS, at least one and at most ``p``, whose estimated phase
    time ``D * per_snp_s + CV_FIXED_S`` fits CV_BUDGET_S."""
    fit = int((CV_BUDGET_S - CV_FIXED_S) / per_snp_s) // CV_PROBE_SNPS
    return int(min(max(fit, 1) * CV_PROBE_SNPS,
                   p // CV_PROBE_SNPS * CV_PROBE_SNPS))


def repack_probe(workdir, host, n, train):
    """Seconds a SNP of the headline phase's host work: one
    CV_PROBE_SNPS-SNP slice of ``host`` written as a .bed, repacked into
    the ``train`` samples and the rest in one read, and the train file's
    stats; the phase writes once, and repacks and takes the stats
    1 + CV_FOLDS times (the split and the folds).  Returns (seconds a
    SNP, the probe's timings)."""
    from flashpca_tpu_torch import PlinkDataset
    from flashpca_tpu_torch.io.plink import subset_samples_many

    root = os.path.join(workdir, "probe")
    t0 = time.time()
    write_packed_fileset(root, host[:CV_PROBE_SNPS], n)
    t_write = time.time() - t0
    ds = PlinkDataset.open(root)
    t0 = time.time()
    subset_samples_many(ds, [(np.flatnonzero(train), root + "_tr"),
                             (np.flatnonzero(~train), root + "_te")])
    t_repack = time.time() - t0
    t0 = time.time()
    PlinkDataset.open(root + "_tr").snp_stats("binom2")
    t_stats = time.time() - t0
    for r in (root, root + "_tr", root + "_te"):
        for ext in (".bed", ".bim", ".fam"):
            os.remove(r + ext)
    probe = {"snps": CV_PROBE_SNPS, "write_s": t_write,
             "repack_s": t_repack, "stats_s": t_stats}
    host_s = t_write + (1 + CV_FOLDS) * (t_repack + t_stats)
    return host_s / CV_PROBE_SNPS + CV_CARD_S_PER_SNP, probe


def headline_cv_split(dev, host, center, scale, n, seed=SCCA_SEED):
    """Penalty selection at the full sample width on the headline's own
    bytes: the first D SNP rows of ``host`` (:func:`cv_phase_snps` from
    :func:`repack_probe`) written as a PLINK fileset (the free disk
    checked first: three times the source's bytes), the headline
    SCCA's phenotypes (:func:`scca_phenotypes` on a resident operator of
    the cut), then ``split_scca`` (CV_PROP_TRAIN, SCCA_NDIM dimensions,
    the SCCA_GRID_L1 / sqrt(D) x SCCA_GRID_L2 grid; its workdir kept)
    and ``cv_scca`` (CV_FOLDS folds, ``init=True``, the default workdir)
    on the card, counts set to 0 just before and read just after each.
    Held: each took the grid path (one scca_grid a split or fold, no
    sequential scca() cell; the split's B1 and B2 launches exactly its
    grid's steps, d passes and two projections), the best split cell
    against a solo scca() of it on the train fileset (SCCA_GRID_D_BAR,
    SCCA_GRID_UV_BAR), its dim-1 test correlation recomputed with a
    float64 PackedOperator on the test bytes (CV_F64_CORR_BAR) and at
    least CV_MIN_CORR, three SNP rows of the train fileset equal to the
    source's codes at ``train_idx``, and cv_scca's temporary directory
    gone.  Per fold the repack seconds and the
    source's packed GB/s, and the seconds of init, grid and projection
    are printed.  Returns (the kernels rows of B1 and B2 at kc 16 on the
    split's and the first fold's train operators, with each path's
    launches of the kernel at every width on its train and test
    operators and their split by kc, and a summary)."""
    import shutil

    import torch

    import flashpca_tpu_torch.io.plink as tplink
    from flashpca_tpu_torch import (PackedOperator, PlinkDataset, cv_scca,
                                    scca, split_scca)
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.models import scca_split as split_mod
    from flashpca_tpu_torch.ops.standardize import standardize
    from flashpca_tpu_torch.utils.device import host64

    cv_mod = sys.modules["flashpca_tpu_torch.models.scca"]
    p, nb = host.shape
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        split_mask = np.random.default_rng(1).uniform(size=n) < CV_PROP_TRAIN
        with Phase(f"repack probe: {CV_PROBE_SNPS} SNPs x {n} samples"):
            per_snp, probe = repack_probe(workdir, host, n, split_mask)
        D = cv_phase_snps(per_snp, p)
        # the source, the split's kept train and test, a fold's both
        need = 3 * D * nb
        free = shutil.disk_usage(workdir).free
        say(f"   probe {probe}; {per_snp * 1e3:.3f} ms a SNP: D = {D} of "
            f"{p} SNPs (estimate {D * per_snp + CV_FIXED_S:.0f} s of the "
            f"{CV_BUDGET_S:.0f} s budget), all {n} samples; disk "
            f"{free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed")
        if free < need:
            raise AssertionError(f"headline cv/split: {free} bytes free "
                                 f"under {workdir}, {need} needed")
        out.update(snps=D, samples=n, probe=probe, per_snp_ms=per_snp * 1e3)
        root = os.path.join(workdir, "cut")
        with Phase(f"the first {D} SNPs to {root}.bed") as ph:
            write_packed_fileset(root, host[:D], n)
        out["write_s"] = ph.seconds
        with Phase("SCCA phenotypes on the cut"):
            op = PackedOperator(host[:D], center[:D], scale[:D], n,
                                device=dev)
            Y, _ = scca_phenotypes(op, np.random.default_rng(seed))
            del op
            torch.cuda.empty_cache()
        l1 = np.array(SCCA_GRID_L1) / np.sqrt(D)
        l2 = np.array(SCCA_GRID_L2)
        kw = dict(ndim=SCCA_NDIM, maxiter=SCCA_MAXITER, tol=SCCA_TOL,
                  device=dev)

        # split_scca, its workdir kept for the holds
        sdir = os.path.join(workdir, "split")
        targets = [(split_mod, nm, nm) for nm in (
            "subset_samples_many", "scca_grid", "scca", "_project_cells")]
        tpk.reset_launch_counts()
        with CallClock(targets, keep=("scca_grid",)) as clk, \
                tpk.time_launches() as log:
            with Phase(f"split_scca: {len(l1)} x {len(l2)} grid, "
                       f"prop_train {CV_PROP_TRAIN}") as ph:
                sres = split_scca(root, Y, l1, l2, prop_train=CV_PROP_TRAIN,
                                  workdir=sdir, **kw)
        slaunch = dict(tpk.launch_counts)
        skcs = launches_by_kc(log)
        g = clk.results("scca_grid")
        if len(g) != 1 or clk.results("scca"):
            raise AssertionError("headline split_scca: not the grid path "
                                 f"({[c[0] for c in clk.calls]})")
        g = g[0]
        C = len(g.lambda1)
        steps = int(g.n_iters.max(axis=1).sum())
        dims = int((g.n_iters.max(axis=1) > 0).sum())
        proj = 2 * len(tpk._widths(SCCA_NDIM * C))
        want = {"crossprod": steps, "matvec": steps + dims + proj}
        t_sub = clk.seconds("subset_samples_many")
        sp = {"s": ph.seconds, "launches": slaunch, "kcs": skcs,
              "repack_s": t_sub,
              "repack_gb_s": [D * nb / t / 1e9 for t in t_sub],
              "grid_s": clk.seconds("scca_grid")[0],
              "projection_s": clk.seconds("_project_cells"),
              "steps": steps, "train": len(sres.train_idx),
              "test": len(sres.test_idx),
              "best": [sres.best_lambda1, sres.best_lambda2,
                       sres.best_corr]}
        say(f"   split: train {sp['train']}, test {sp['test']}; repack "
            f"{t_sub[0]:.2f} s ({sp['repack_gb_s'][0]:.2f} GB/s of source)"
            f"; grid {sp['grid_s']:.2f} s ({steps} steps), projections "
            + ", ".join(f"{t:.3f}" for t in sp["projection_s"])
            + f" s; B1/B2 launches {slaunch['crossprod']}/"
            f"{slaunch['matvec']} (the grid's {want['crossprod']}/"
            f"{want['matvec']}) at {skcs}; best lambda1 "
            f"{sres.best_lambda1:.4g}, lambda2 {sres.best_lambda2:g}, test "
            f"corr {sres.best_corr:.6f}")
        require_launched(slaunch, SCCA_GRID_PATH, "headline split_scca")
        require_no_first_design(slaunch, "headline split_scca")
        if (dev.type == "cuda"
                and {nm: slaunch[nm] for nm in SCCA_GRID_PATH} != want):
            raise AssertionError(f"headline split_scca: launches {slaunch}, "
                                 f"the grid's {want}")

        # the best cell: solo scca() on the train fileset, and its test
        # correlation in float64
        i = int(np.flatnonzero(l1 == sres.best_lambda1)[0])
        j = int(np.flatnonzero(l2 == sres.best_lambda2)[0])
        c = i * len(l2) + j
        base = os.path.join(sdir, "cut")
        ds_tr = PlinkDataset.open(base + "_train")
        ds_te = PlinkDataset.open(base + "_test")
        tr, te = sres.train_idx, sres.test_idx
        with Phase("solo scca() of the best cell on the train fileset"):
            solo = scca(ds_tr, Y[tr], float(l1[i]), float(l2[j]), seed=1,
                        **kw)
        d_rel = np.abs(g.d[:, c] - solo.d) / np.abs(solo.d)
        uv = max(float(np.abs(g.U[:, :, c] - solo.U).max()),
                 float(np.abs(g.V[:, :, c] - solo.V).max()))
        op_tr = clk.first_args["scca_grid"][0]
        xm, xs = op_tr.center, op_tr.scale
        with Phase("the best cell's test correlation in float64"):
            op64 = PackedOperator(ds_te.read_packed(), xm, xs,
                                  ds_te.n_samples, device=dev,
                                  dtype=torch.float64, block_size=512)
            xu = host64(op64.prod(g.U[:, 0, c]))
            del op64
        _, y_mean, y_sd = standardize(Y[tr].copy(), "sd")
        yv = ((Y[te] - y_mean) / y_sd) @ g.V[:, 0, c]
        r64 = float(np.corrcoef(xu, yv)[0, 1])
        rows_ok = all(np.array_equal(
            ds_tr.read_codes(r, r + 1)[0],
            tplink.unpack_codes(host[r:r + 1], n)[0, tr])
            for r in (0, D // 2, D - 1))
        sp.update(cell=c, solo_d_rel=d_rel.tolist(), solo_uv_abs=uv,
                  solo_converged=bool(solo.converged), corr_float64=r64,
                  rows_equal=rows_ok)
        say(f"   best cell {c} vs solo scca(): d rel " + " ".join(
            f"{x:.2e}" for x in d_rel) + f", U/V {uv:.2e}; test corr "
            f"{sres.best_corr:.8f}, float64 {r64:.8f}; train rows 0, "
            f"{D // 2}, {D - 1} equal to the source's: {rows_ok}")
        if not (solo.converged and g.converged[c]
                and d_rel.max() <= SCCA_GRID_D_BAR
                and uv <= SCCA_GRID_UV_BAR):
            raise AssertionError(f"headline split_scca: cell {c} off its "
                                 f"solo run ({sp})")
        if not (abs(r64 - sres.best_corr) <= CV_F64_CORR_BAR
                and sres.best_corr >= CV_MIN_CORR and rows_ok):
            raise AssertionError(f"headline split_scca: {sp}")
        out["split"] = sp

        # cv_scca in the default workdir
        cv_targets = [(tplink, "subset_samples_many", "subset_samples_many"),
                      (tempfile, "mkdtemp", "mkdtemp")] + [
            (cv_mod, nm, nm) for nm in ("scca", "scca_grid",
                                        "_project_cells")]
        tpk.reset_launch_counts()
        with CallClock(cv_targets, keep=("scca_grid",)) as clk, \
                tpk.time_launches() as log:
            with Phase(f"cv_scca: {CV_FOLDS} folds, init=True") as ph:
                cres = cv_scca(root, Y, l1, l2, nfolds=CV_FOLDS, init=True,
                               **kw)
        claunch = dict(tpk.launch_counts)
        ckcs = launches_by_kc(log)
        t_sub = clk.seconds("subset_samples_many")
        cv = {"s": ph.seconds, "launches": claunch, "kcs": ckcs,
              "folds": np.bincount(cres.folds).tolist(),
              "repack_s": t_sub, "init_s": clk.seconds("scca"),
              "grid_s": clk.seconds("scca_grid"),
              "projection_s": clk.seconds("_project_cells"),
              "best": [cres.best_lambda1, cres.best_lambda2,
                       cres.best_corr]}
        cv["repack_gb_s"] = [D * nb / t / 1e9 for t in t_sub]
        for f, t in enumerate(t_sub):
            say(f"   fold {f + 1}: {cv['folds'][f]} test samples; repack "
                f"{t:.2f} s ({D * nb / t / 1e9:.2f} GB/s of source), "
                f"init {cv['init_s'][f]:.2f} s, grid {cv['grid_s'][f]:.2f}"
                f" s, projection {cv['projection_s'][f]:.3f} s")
        say(f"   cv: {ph.seconds:.2f} s; B1/B2 launches "
            f"{claunch['crossprod']}/{claunch['matvec']} at {ckcs}; best "
            f"lambda1 {cres.best_lambda1:.4g}, lambda2 "
            f"{cres.best_lambda2:g}, pooled corr {cres.best_corr:.6f}")
        require_launched(claunch, SCCA_GRID_PATH, "headline cv_scca")
        require_no_first_design(claunch, "headline cv_scca")
        if (len(cv["grid_s"]) != CV_FOLDS or len(cv["init_s"]) != CV_FOLDS
                or (dev.type == "cuda"
                    and "16" not in ckcs.get("crossprod", {}))):
            raise AssertionError(f"headline cv_scca: not the grid path "
                                 f"({[c[0] for c in clk.calls]}, {ckcs})")
        made = clk.results("mkdtemp")
        if len(made) != 1 or os.path.exists(made[0]):
            raise AssertionError(f"headline cv_scca: scratch {made} left")
        out["cv"] = cv

        # B1 and B2 at kc 16 on the split's and on fold 0's train
        # operators (the ones their grids ran on)
        rows = []
        with Phase("kernel times: the grid's B1 and B2 on the train bytes"):
            for op, launched, kcs, path in (
                    (op_tr, slaunch, skcs, "split_scca"),
                    (clk.first_args["scca_grid"][0], claunch, ckcs,
                     "cv_scca")):
                for row in time_kernels(op, [("crossprod", 16),
                                             ("matvec", 16)],
                                        launched, None, slices=8):
                    rows.append(dict(
                        row, path=path,
                        launches_by_kc=kcs.get(row["name"], {}),
                        launches_cover="every width, train and test "
                                       "operators"))
        del op, op_tr, clk
        torch.cuda.empty_cache()
    return rows, out


def launches_by_kc(log):
    """{kernel: {kc: launches}} from a ``time_launches`` log."""
    out = {}
    for nm, kc, _, _ in log:
        by = out.setdefault(nm, {})
        by[str(kc)] = by.get(str(kc), 0) + 1
    return {nm: dict(sorted(by.items(), key=lambda kv: int(kv[0])))
            for nm, by in out.items()}


def dense_matrix(op, rows=1024):
    """The packed operator's standardized genotypes as one float32 (N,
    p) tensor X on the card, and their float64 gram X X^T / p beside it
    (N x N: 20.1 GB at the dense headline), from one decode pass in
    blocks of ``rows`` SNPs in float64 with the operator's float64
    stats: each block is added to the gram in float64 and rounded once
    to float32 into X."""
    import torch

    from flashpca_tpu_torch.ops.genotypes import (decode_standardized,
                                                  unpermute_samples)
    from flashpca_tpu_torch.ops.standardize import lookup_tables

    n, p = op.n_samples, op.n_snps
    mean, invsd = (torch.as_tensor(t, device=op.device) for t in
                   lookup_tables(op.center, op.scale, dtype=np.float64))
    X = torch.empty((n, p), dtype=torch.float32, device=op.device)
    G = torch.zeros((n, n), dtype=torch.float64, device=op.device)
    for r0 in range(0, p, rows):
        r1 = min(r0 + rows, p)
        g = decode_standardized(op.packed[r0:r1], mean[r0:r1],
                                invsd[r0:r1], torch.float64)
        Xb = unpermute_samples(g.T, n)
        G.addmm_(Xb, Xb.T)
        X[:, r0:r1] = Xb
        del g, Xb
    G /= p
    return X, G


def f64_eigsh(A, nev):
    """Top ``nev`` eigenpairs of a float64 symmetric matrix on its
    device, by the port's block Lanczos in float64 to tol 1e-12."""
    import torch

    from flashpca_tpu_torch.solvers.block_lanczos import eigsh_block

    return eigsh_block(lambda x: A @ x, A.shape[0], nev, block=16, ncv=160,
                       maxiter=200, tol=1e-12, dtype=torch.float64,
                       device=A.device, seed=3)


def dense_headline(dev, smi, n=DENSE_N, p=DENSE_P, k=20, seed=DENSE_SEED):
    """The dense path at the headline's SNP width: genotypes generated
    packed on the card (``card_data``), decoded into one float32 (n, p)
    X there (:func:`dense_matrix`) and held by ``DenseOperator(X,
    center=mean, scale=sd)`` -- torch.matmul products, no kernel, so no
    launch may be counted on it.  ``pca(dense, k)`` (float32,
    ``polish="contract"``) and ``check(dense, ...)``, their extra peak
    device memory at most DENSE_PEAK_SHARE of X's bytes (any copy of X
    fails it); then the resident PackedOperator's ``pca`` and ``check``
    on the same bytes (B1-B4 must launch), and from start seed
    WITNESS_SEED.  Held: the dense result's check mse < 1e-8 through the
    dense operator and through the packed one; on the population pairs
    (above 1.5 x the Marchenko-Pastur edge (sqrt(n) + sqrt(p))^2 / p)
    its eigenvalues within 1e-6 of the largest of the packed run's and
    its vectors by the twin rule (:func:`twin_cosines`, |cos| or the
    cluster's span >= 1 - 1e-6); on the bulk pairs, which no two
    float32 solves of another arithmetic resolve alike (the tall
    headline's BULK_BAR), eigenvalues within BULK_BAR of the largest,
    their vectors printed beside the packed run's start-seed witness;
    both runs' eigenvalues against the float64 X X^T / p formed on the
    card in the same decode pass as X (:func:`dense_matrix`,
    :func:`f64_eigsh`): none above it by more than EIG_BAR of the
    largest (Ritz values are lower bounds), the population pairs not
    below it by more than EIG_BAR either, the bulk pairs not below it by
    more than DENSE_BULK_F64_BAR -- here the bulk is 20 pairs within
    7e-5 of the largest, which the capped float32 schedule leaves up to
    about that far below (the check contract holds all pairs, above);
    ``ucca`` on
    both operators with UCCA_K seeded phenotypes
    (:func:`causal_phenotypes`), each held on the causal window to a
    float64 crossprod (:func:`hold_ucca`).  Printed: both runs'
    ``n_ops``, the dense plain and two-float gram's ms a pass (CUDA
    events, kc 16 and 24), the walls and the card."""
    import torch

    from flashpca_tpu_torch import (DenseOperator, PackedOperator, check,
                                    pca, ucca)
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import permute_samples
    from flashpca_tpu_torch.utils.device import host64

    out = {"n": n, "p": p, "k": k, "card": smi}
    with Phase(f"dense headline data: {n} x {p} generated packed on the "
               "card, decoded into a float32 X and a float64 X X^T / p"
               ) as ph:
        packed, mean, sd, sumsq = card_data(dev, n, p, seed)
        op = PackedOperator(packed, mean, sd, n, device=dev,
                            snp_sumsq=sumsq)
        del packed
        X, G = dense_matrix(op)
        dense = DenseOperator(X, center=mean, scale=sd, device=dev)
    out["gen_s"] = ph.seconds
    x_bytes = X.numel() * X.element_size()
    if dense.X.data_ptr() != X.data_ptr():
        raise AssertionError("DenseOperator copied the card's X")
    del X
    say(f"   X {x_bytes / 1e9:.2f} GB float32 on the card, packed "
        f"{op.packed.numel() / 1e9:.2f} GB; {smi}")
    with Phase("float64 reference: eigsh of X X^T / p on the card") as ph:
        f64 = f64_eigsh(G, k + 8)
    out["ref_s"] = ph.seconds
    del G
    torch.cuda.empty_cache()

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tpk.reset_launch_counts()
    with Phase(f"pca(dense, {k}) polish='contract' float32") as ph:
        res = pca(dense, k)
    out["pca_s"] = ph.seconds
    with Phase("check(dense, U, d)") as ph:
        chk = check(dense, res.vectors, res.values)
    out["check_s"] = ph.seconds
    sync()
    extra = torch.cuda.max_memory_allocated() - base
    dense_launches = sum(tpk.launch_counts.values())
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               gate_mse=res.gate_mse, check_mse=chk.mse,
               extra_peak_gb=extra / 1e9, x_gb=x_bytes / 1e9,
               extra_peak_share=extra / x_bytes, launches=dense_launches)
    say(f"   dense: n_ops {res.n_ops}, n_restarts {res.n_restarts}, gate "
        f"mse {res.gate_mse!r}, check mse {chk.mse!r}; pca wall "
        f"{out['pca_s']:.2f} s, check wall {out['check_s']:.2f} s; extra "
        f"peak device memory {extra / 1e9:.3f} GB = {extra / x_bytes:.4f} "
        f"of X (bar {DENSE_PEAK_SHARE}); kernel launches {dense_launches}")
    if dense_launches:
        raise AssertionError(f"the dense operator launched kernels: "
                             f"{dict(tpk.launch_counts)}")
    if not extra <= DENSE_PEAK_SHARE * x_bytes:
        raise AssertionError(f"dense headline: extra peak {extra / 1e9:.2f}"
                             f" GB > {DENSE_PEAK_SHARE} x X's bytes")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and chk.mse < 1e-8):
        raise AssertionError(f"dense headline: check mse {chk.mse!r} or "
                             "non-finite / misshapen vectors")

    reps = 10
    panel = {kc: torch.randn((n, kc), device=dev) for kc in (16, 24)}
    out["gram_ms"] = event_ms(lambda: dense.gram_permuted(panel[16]), reps)
    out["gram_ff_ms"] = event_ms(
        lambda: dense.gram_ff_permuted(panel[24]), reps)
    say(f"   dense gram pass: plain {out['gram_ms']:.2f} ms (kc 16), "
        f"two-float {out['gram_ff_ms']:.2f} ms (kc 24), median of {reps}")
    del panel

    tpk.reset_launch_counts()
    with Phase(f"pca(packed, {k}) on the same bytes") as ph:
        res_p = pca(op, k)
    out["packed_pca_s"] = ph.seconds
    with Phase("check(packed, U, d) of both results") as ph:
        chk_p = check(op, res_p.vectors, res_p.values)
        chk_dp = check(op, res.vectors, res.values)
    launches = dict(tpk.launch_counts)
    require_launched(launches, WIDE_PATH, "dense headline's packed run")
    require_no_first_design(launches, "dense headline's packed run")
    with Phase(f"pca(packed, {k}) from start seed {WITNESS_SEED}"):
        alt = pca(op, k, seed=WITNESS_SEED)
    d, d_p = res.values, res_p.values
    err = np.abs(d - d_p) / d_p[0]
    bulk = d_p < 1.5 * (np.sqrt(n) + np.sqrt(p)) ** 2 / p
    pops = ~bulk
    cos, held, clusters = twin_cosines(res.vectors[:, pops],
                                       res_p.vectors[:, pops], d_p[pops],
                                       TWIN_NEAR * d_p[0])
    bulk_cos = twin_cosines(res.vectors, res_p.vectors, d_p, 0.0)[0][bulk]
    witness_cos = twin_cosines(alt.vectors, res_p.vectors, d_p,
                               0.0)[0][bulk]
    out.update(packed_n_ops=res_p.n_ops, packed_check_mse=chk_p.mse,
               check_mse_through_packed=chk_dp.mse,
               population_pairs=int(pops.sum()),
               eig_err_of_largest=float(err[pops].max()),
               bulk_eig_err_of_largest=float(err[bulk].max(initial=0.0)),
               min_held=float(held.min()), clusters=clusters,
               bulk_abs_cos=bulk_cos.tolist(),
               witness_bulk_abs_cos=witness_cos.tolist(),
               packed_launches={nm: launches[nm] for nm in WIDE_PATH})
    say(f"   n_ops: dense {res.n_ops}, packed {res_p.n_ops}; check mse "
        f"through the packed operator: dense result {chk_dp.mse!r}, packed "
        f"result {chk_p.mse!r}")
    say("   d_dense " + " ".join(f"{x:.6f}" for x in d))
    say("   d_packed " + " ".join(f"{x:.6f}" for x in d_p))
    say(f"   {int(pops.sum())} population pairs: eigenvalues dense vs "
        f"packed {err[pops].max():.2e} of the largest (bar 1e-6); twins "
        f"(pairs closer than {TWIN_NEAR} of the largest: {clusters}) "
        + " ".join(f"{c:.8f}" for c in held))
    say(f"   {int(bulk.sum())} bulk pairs: eigenvalues dense vs packed "
        f"{err[bulk].max(initial=0.0):.2e} of the largest (bar {BULK_BAR});"
        " |cos| dense vs packed, not held: "
        + " ".join(f"{c:.4f}" for c in bulk_cos)
        + f"; packed start seed {WITNESS_SEED} vs 1: "
        + " ".join(f"{c:.4f}" for c in witness_cos))
    if not (chk_dp.mse < 1e-8 and err[pops].max() <= 1e-6
            and held.min() >= 1 - 1e-6
            and err[bulk].max(initial=0.0) <= BULK_BAR):
        raise AssertionError(
            f"dense headline vs packed: check mse {chk_dp.mse!r} through "
            f"the packed operator, population eigenvalues "
            f"{err[pops].max():.2e} of the largest, twins "
            f"{held.min():.8f}, bulk eigenvalues "
            f"{err[bulk].max(initial=0.0):.2e}")

    Y, window, causal = causal_phenotypes(op, UCCA_K, seed)
    with Phase(f"ucca(dense, Y) and ucca(packed, Y), {UCCA_K} "
               "phenotypes") as ph:
        u_d = ucca(dense, Y)
        u_p = ucca(op, Y)
    out["ucca_s"] = ph.seconds
    lut6 = tpk.lut_rows(*op._ff_luts())
    x = permute_samples(torch.as_tensor(centred_panel(Y), device=dev),
                        op.nbytes)
    ref = ucca_from_products(
        host64(f64_product(op.packed[window], lut6[:, window], x,
                           transpose=False)), op.snp_sumsq[window], Y)
    out["ucca_errs"] = {
        "dense": hold_ucca("dense ucca vs float64", u_d.result[window], ref),
        "packed": hold_ucca("packed ucca vs float64", u_p.result[window],
                            ref)}
    out["ucca_causal_p"] = u_d.pval[causal].tolist()
    say(f"   causal SNPs {causal.tolist()} at P (dense) "
        + " ".join(f"{v:.2e}" for v in u_d.pval[causal]))
    del dense
    d_ref = f64.eigenvalues[:k]
    say(f"   reference: {f64.n_ops} passes, converged {f64.converged}")
    say("   d_ref " + " ".join(f"{x:.6f}" for x in d_ref))
    for who, dd in (("dense", d), ("packed", d_p)):
        off = (dd - d_ref) / d_ref[0]
        say(f"   (d_{who} - d_ref) / d_ref max: "
            + " ".join(f"{x:.2e}" for x in off))
        bad = ((off > EIG_BAR) | (pops & (-off > EIG_BAR))
               | (bulk & (-off > DENSE_BULK_F64_BAR)))
        out[f"{who}_eig_err_vs_f64"] = float(np.abs(off[pops]).max())
        out[f"{who}_bulk_below_f64"] = float(-off[bulk].min(initial=0.0))
        if not f64.converged or bad.any():
            raise AssertionError(
                f"dense headline: {who} eigenvalues {np.flatnonzero(bad)} "
                f"off the float64 reference beyond {EIG_BAR} of the "
                f"largest (above it, or a population pair below it), or "
                f"a bulk pair below it by more than {DENSE_BULK_F64_BAR}")
    del op
    return out


def twin_cosines(U, U_r, d_r, near):
    """Each vector of ``U`` against its twin in ``U_r`` (columns in the
    order of the eigenvalues ``d_r``, descending): |cos| of the pair,
    and the value a bar holds -- that |cos|, or, for a vector whose
    eigenvalue lies within ``near`` of a neighbour's (a cluster that a
    float32 solve does not resolve pair by pair), the cosine of the
    largest principal angle between the cluster's span in ``U`` and in
    ``U_r``.  Returns (|cos|, held, clusters of two or more)."""
    U = U / np.linalg.norm(U, axis=0)
    U_r = U_r / np.linalg.norm(U_r, axis=0)
    cos = np.abs(np.sum(U * U_r, axis=0))
    held = cos.copy()
    clusters, start = [], 0
    for j in range(1, len(d_r) + 1):
        if j == len(d_r) or d_r[j - 1] - d_r[j] > near:
            if j - start > 1:
                c = list(range(start, j))
                held[c] = np.linalg.svd(U_r[:, c].T @ U[:, c],
                                        compute_uv=False).min()
                clusters.append(c)
            start = j
    return cos, held, clusters


def streamed_scca(op, tw):
    """SCCA on the streamed headline operator ``op``, against the
    resident headline's ``tw`` (:func:`scca_headline`): ``scca(op, Y)``
    with one dimension, SCCA_TWIN_ITERS iterations at tol 0, on the host
    engine (counts set to 0 just before and read just after: B1 and B2
    must launch), U and V within SCCA_STREAM_BAR of the resident device
    engine's; then ``scca_grid`` of 16 zero-penalty cells and one solo
    run at zero penalties, SCCA_STREAM_GRID_ITERS iterations each at tol
    0: the grid must stage no more block passes than the solo run (its
    cells share every pass), and each cell must hold the solo result
    within SCCA_STREAM_BAR."""
    from flashpca_tpu_torch import scca, scca_grid
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    Y, lam1, twin = tw["Y"], tw["lam1"], tw["twin"]
    out = {}
    tpk.reset_launch_counts()
    op.reset_stats()
    with Phase(f"streamed scca(op, Y), ndim 1, {SCCA_TWIN_ITERS} "
               "iterations at tol 0, host engine") as ph:
        s = scca(op, Y, lam1, SCCA_L2, ndim=1, maxiter=SCCA_TWIN_ITERS,
                 tol=0.0, seed=SCCA_V0_SEED)
    launches = dict(tpk.launch_counts)
    err = max(float(np.abs(s.U - twin.U).max()),
              float(np.abs(s.V - twin.V).max()))
    out["twin"] = {"s": ph.seconds, "passes": op.nops,
                   "launches": {nm: launches[nm]
                                for nm in SCCA_PATH + SCCA_PX},
                   "uv_abs_vs_resident": err}
    say(f"   {op.nops} passes, {scca_launch_text(launches)}; U/V "
        f"vs the resident device engine: max "
        f"abs {err:.2e} (bar {SCCA_STREAM_BAR})")
    require_launched(launches, SCCA_PATH, "streamed scca")
    require_no_first_design(launches, "streamed scca")
    if not err <= SCCA_STREAM_BAR:
        raise AssertionError(f"streamed scca: {err:.2e} off the resident "
                             "device engine")
    zeros = np.zeros(4)
    kw = dict(ndim=1, maxiter=SCCA_STREAM_GRID_ITERS, tol=0.0,
              seed=SCCA_V0_SEED)
    runs = {}
    for what, label, call in (
            ("grid", "scca_grid, 16 zero-penalty cells",
             lambda: scca_grid(op, Y, zeros, zeros, **kw)),
            ("solo", "scca, zero penalties",
             lambda: scca(op, Y, 0.0, 0.0, **kw))):
        op.reset_stats()
        tpk.reset_launch_counts()
        with Phase(f"streamed {label}, {SCCA_STREAM_GRID_ITERS} iterations "
                   "at tol 0") as ph:
            r = call()
        st = op.stats()
        runs[what] = (r, st["staged_host_blocks"], st["nops"], ph.seconds,
                      {nm: tpk.launch_counts[nm]
                       for nm in SCCA_PATH + SCCA_GRID_PATH})
    g, s0 = runs["grid"][0], runs["solo"][0]
    gerr = max(float(np.abs(g.U[:, :, c] - s0.U).max()) for c in range(16))
    gerr = max(gerr, max(float(np.abs(g.V[:, :, c] - s0.V).max())
                         for c in range(16)))
    out["grid"] = {what: {"staged_blocks": b, "passes": n_, "s": t,
                          "launches": lc}
                   for what, (_, b, n_, t, lc) in runs.items()}
    out["grid"]["uv_abs_vs_solo"] = gerr
    say(f"   grid of 16 cells: {runs['grid'][2]} passes, "
        f"{runs['grid'][1]} staged blocks; one solo run: "
        f"{runs['solo'][2]} passes, {runs['solo'][1]} staged blocks; "
        f"cells vs the solo run max abs {gerr:.2e}")
    if not (runs["grid"][1] <= runs["solo"][1] and gerr <= SCCA_STREAM_BAR):
        raise AssertionError(f"streamed scca_grid: {runs['grid'][1]} staged "
                             f"blocks vs the solo run's {runs['solo'][1]}, "
                             f"cells {gerr:.2e} off it")
    return out


def streamed_headline(dev, host, center, scale, sumsq, resident,
                      resident_launch_ms, witness=None, twins=None,
                      memory_mb=STREAM_MEMORY_MB, scca_twins=None):
    """The reference's headline job under its 2 GB bound: the headline's
    bytes, copied to the host after the resident phase, streamed by a
    StreamingPackedOperator with two device block buffers of
    ``memory_mb`` MB in all and no block cache.  First a staging trial
    (one plain gram pass at kc 16 with the prefetch worker on, then one
    with it off, after a warm-up pass) and the link's rate on one block;
    then the main path, counts set
    to 0 just before ``pca(op, k)`` and read just after ``check()``,
    held to the resident run ``resident`` (its PCAResult): check mse <
    1e-8, eigenvalues within 2e-6 relative, every vector's |cos| with
    its resident twin >= 1 - 1e-6 -- or, for a vector of a pair closer
    than TWIN_NEAR of the largest, which a float32 solve does not
    resolve one by one, the pair's span (:func:`twin_cosines`; the
    resident headline's ``witness``, its |cos| from another start seed,
    printed beside) -- the packed bytes on the device within
    ``memory_mb``, B1-B4 launched and no first design.  Then, given the
    resident headline's ``twins`` (:func:`project_ucca`), ``ucca`` and
    ``_project_operator`` on the same streamed operator, counts set to 0
    just before and read just after each: B1 must run for ucca, whose
    result must equal the resident one bit for bit (B1's rows do not
    depend on the blocking), and B2 for project, within PROJECT_BAR
    relative (column norms) of the resident projection.  Given the
    resident headline's ``scca_twins``, :func:`streamed_scca` on the
    same operator.  Then B1-B4,
    B2 at kc 24 and B1 at kc 8 (project's and ucca's), and B1/B2 on
    the one column of the SCCA solo runs, held to their plain versions
    and timed on one resident block of the streamed shape (the SCCA
    grid's rows: the kc 16 ones with its launches).  Returns (the kernels rows of the block shape, a summary)."""
    import torch

    from flashpca_tpu_torch import PackedOperator, StreamingPackedOperator
    from flashpca_tpu_torch import check, pca, ucca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.models.project import _project_operator

    n, k = resident.vectors.shape
    op = StreamingPackedOperator(host, center, scale, n, memory_mb=memory_mb,
                                 cache_mb=0, device=dev, snp_sumsq=sumsq)
    st = op.stats()
    say(f"   {op.n_blocks} blocks of {op.block_snps} SNPs "
        f"({st['block_bytes'] / 1e9:.3f} GB each) of "
        f"{st['packed_bytes'] / 1e9:.2f} GB on the host, prefetch "
        f"default {op._prefetch}")
    out = {"memory_mb": memory_mb, "n_blocks": op.n_blocks,
           "block_snps": op.block_snps, "block_bytes": st["block_bytes"],
           "prefetch": op._prefetch}

    # staging trial: one plain gram pass at kc 16 per turn, after one
    # that allocates the staging buffers
    default = op._prefetch
    x = torch.randn((op.n4, 16), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(93))
    trial = {}
    with Phase("streamed gram passes, prefetch on / off"):
        op.gram_permuted(x)
        for pf in (True, False):
            op._prefetch = pf
            op.reset_stats()
            sync()
            t0 = time.perf_counter()
            op.gram_permuted(x)
            sync()
            s = op.stats()
            row = {"wall_s": time.perf_counter() - t0,
                   **{key: s[key] for key in ("fill_s", "put_s", "sync_s",
                                              "wait_s")}}
            trial.setdefault(f"prefetch_{pf}", []).append(row)
            say(f"   prefetch {pf}: pass {row['wall_s']:.3f} s, "
                + ", ".join(f"{key} {row[key]:.3f}" for key in
                            ("fill_s", "put_s", "sync_s", "wait_s"))
                + f"; {s['staged_bytes'] / row['wall_s'] / 1e9:.2f} packed "
                "GB/s")
        op._prefetch = default
        # the link alone: one block, pinned host buffer to device buffer
        link_ms = event_ms(lambda: op._dev[0].copy_(op._host[0],
                                                    non_blocking=True), 3)
        out["link_gb_s"] = st["block_bytes"] / link_ms / 1e6
        say(f"   one block host to device: {link_ms:.2f} ms, "
            f"{out['link_gb_s']:.2f} GB/s")
    out["prefetch_trial"] = trial
    del x

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    op.reset_stats()
    # the streamed path: counts set to 0 just before pca(), read just
    # after check(); B1-B4 must have launched
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"streamed pca(op, {k}) polish='contract' float32, "
                   f"memory_mb={memory_mb}") as ph:
            res = pca(op, k)
        out["pca_s"] = ph.seconds
        with Phase("streamed check(op, U, d)") as ph:
            chk = check(op, res.vectors, res.values)
        out["check_s"] = ph.seconds
    launches = dict(tpk.launch_counts)
    sync()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    st = op.stats()
    wall = out["pca_s"] + out["check_s"]
    passes = st["staged_host_blocks"] / op.n_blocks
    busy, _ = busy_and_span(log)
    launch_ms = launch_medians(log)
    d, d_r = res.values, resident.values
    rel = np.abs(d - d_r) / d_r
    # pairs closer than the float32 solves resolve one by one
    # (TWIN_NEAR) are held by their span
    cos, held, clusters = twin_cosines(res.vectors, resident.vectors, d_r,
                                       TWIN_NEAR * d_r[0])
    say(f"   n_ops {res.n_ops}, n_restarts {res.n_restarts}, contract gate "
        f"mse {res.gate_mse!r}, check mse {chk.mse!r}, converged "
        f"{res.converged}")
    say(f"   pca wall {out['pca_s']:.2f} s, check wall {out['check_s']:.2f} "
        f"s, peak device memory {out['peak_gb']:.2f} GB, packed bytes on "
        f"the device {st['device_bytes']} (bound {memory_mb << 20})")
    say(f"   {passes:.0f} passes, {st['staged_bytes'] / 1e9:.2f} GB streamed,"
        f" {st['staged_bytes'] / wall / 1e9:.2f} packed GB/s over the walls;"
        f" per pass fill {st['fill_s'] / passes:.3f} s ("
        f"{st['staged_bytes'] / st['fill_s'] / 1e9:.2f} GB/s), put "
        f"{st['put_s'] / passes:.3f} s, sync {st['sync_s'] / passes:.3f} s,"
        f" wait {st['wait_s'] / passes:.3f} s; B1-B4 busy {busy:.2f} s "
        f"({busy / wall:.1%} of the walls)")
    say("   per-launch medians beside the resident headline's: "
        + ", ".join(f"{key} {ms:.2f} ({resident_launch_ms.get(key, 0):.2f})"
                    for key, ms in sorted(launch_ms.items())))
    say("   eigenvalues vs resident, relative: "
        + " ".join(f"{e:.1e}" for e in rel))
    say("   d_resident " + " ".join(f"{x:.6f}" for x in d_r))
    say("   gaps to the next, of the largest: "
        + " ".join(f"{g:.1e}" for g in -np.diff(d_r) / d_r[0]))
    say("   |cos| with the resident vectors: "
        + " ".join(f"{c:.8f}" for c in cos))
    if witness is not None:
        say(f"   witness, resident start seed {witness['seed']} vs 1: "
            + " ".join(f"{c:.8f}" for c in witness["abs_cos"]))
    say(f"   pairs closer than {TWIN_NEAR} of the largest: {clusters}; "
        "|cos|, or the pair's largest principal angle's cosine: "
        + " ".join(f"{c:.8f}" for c in held))
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               gate_mse=res.gate_mse, check_mse=chk.mse, stats=st,
               passes=passes, streamed_gb=st["staged_bytes"] / 1e9,
               packed_gb_s=st["staged_bytes"] / wall / 1e9,
               fill_gb_s=st["staged_bytes"] / st["fill_s"] / 1e9,
               b1_b4_busy_s=busy, b1_b4_busy_share=busy / wall,
               launches={nm: launches[nm] for nm in WIDE_PATH},
               launch_ms=launch_ms,
               eig_rel_err_vs_resident=float(rel.max()),
               min_abs_cos=float(cos.min()),
               held_by_span=np.flatnonzero(cos < 1 - 1e-6).tolist(),
               min_span_cos=float(held.min()), clusters=clusters)
    require_launched(launches, WIDE_PATH, "streamed headline")
    require_no_first_design(launches, "streamed headline")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and np.isfinite(res.values).all()):
        raise AssertionError("streamed headline: non-finite or misshapen "
                             "result")
    if not chk.mse < 1e-8:
        raise AssertionError(f"streamed headline: check mse {chk.mse:.3e}")
    if not rel.max() <= 2e-6:
        raise AssertionError(f"streamed headline: eigenvalues "
                             f"{rel.max():.2e} relative off the resident run")
    bad = (cos < 1 - 1e-6) & (held < 1 - 1e-6)
    if bad.any():
        raise AssertionError(
            f"streamed headline: vectors {np.flatnonzero(bad)} off the "
            f"resident ones (|cos| {cos[bad]}, their clusters' spans "
            f"{held[bad]})")
    if dev.type == "cuda" and not 0 < st["device_bytes"] <= memory_mb << 20:
        raise AssertionError(f"streamed headline: {st['device_bytes']} "
                             f"packed bytes on the device, bound {memory_mb} "
                             "MiB")
    twin_launches = {}
    if twins is not None:
        tpk.reset_launch_counts()
        with Phase(f"streamed ucca(op, Y), memory_mb={memory_mb}") as ph:
            u = ucca(op, twins["Y"])
        twin_launches["ucca"] = dict(tpk.launch_counts)
        out["ucca"] = {"s": ph.seconds,
                       "launches": twin_launches["ucca"]["crossprod"]}
        tpk.reset_launch_counts()
        with Phase("streamed _project_operator(op, V, p)") as ph:
            Px = _project_operator(op, twins["V"], op.n_snps)
        twin_launches["project"] = dict(tpk.launch_counts)
        out["project"] = {"s": ph.seconds,
                          "launches": twin_launches["project"]["matvec"]}
        same = np.array_equal(u.result, twins["ucca"], equal_nan=True)
        err = column_rel_err(Px, twins["Px"])
        out["ucca"]["equal_to_resident"] = bool(same)
        out["project"]["col_rel_err_vs_resident"] = float(err.max())
        say(f"   streamed ucca bit-equal to the resident one: {same} (B1 "
            f"launches {out['ucca']['launches']}); streamed project vs "
            f"resident column rel err max {err.max():.2e} (B2 launches "
            f"{out['project']['launches']})")
        require_launched(twin_launches["ucca"], UCCA_PATH, "streamed ucca")
        require_launched(twin_launches["project"], PROJECT_PATH,
                         "streamed project")
        for what in ("ucca", "project"):
            require_no_first_design(twin_launches[what], f"streamed {what}")
        if not same:
            raise AssertionError("streamed ucca: not equal to the resident "
                                 "result")
        if not err.max() < PROJECT_BAR:
            raise AssertionError(f"streamed project: {err.max():.2e} "
                                 "relative off the resident projection")
    if scca_twins is not None:
        out["scca"] = streamed_scca(op, scca_twins)
    bs = op.block_snps
    op.close()
    del op
    torch.cuda.empty_cache()

    # B1-B4 at the streamed block's shape, on one block held resident
    with Phase(f"kernel times on one {bs}-SNP block"):
        bop = PackedOperator(host[:bs], center[:bs], scale[:bs], n,
                             device=dev, snp_sumsq=sumsq[:bs])
        rows = time_kernels(bop, [("crossprod", 16), ("matvec", 16),
                                  ("crossprod_ff", 24), ("matvec_ff", 24)],
                            launches, None, slices=4)
        for row in rows:
            row.update(path="streaming",
                       stream_launch_ms=launch_ms.get(f"{row['name']}/"
                                                      f"{row['k']}"))
        for what, name, kc in (("project", "matvec", 24),
                               ("ucca", "crossprod", 8)):
            if what in twin_launches:
                for row in time_kernels(bop, [(name, kc)],
                                        twin_launches[what], None,
                                        slices=4):
                    rows.append(dict(row, path=f"{what}_streaming"))
        if "scca" in out:
            sc = out["scca"]
            rows += scca_rows(
                bop, {nm: sc["twin"]["launches"][nm]
                      + sc["grid"]["solo"]["launches"][nm]
                      for nm in SCCA_PATH + SCCA_PX},
                sc["grid"]["grid"]["launches"],
                [r for r in rows if r["path"] == "streaming"], "_streaming",
                slices=4)
        del bop
    return rows, out


def f64_reference(top, nev, rows=2048, depth=None):
    """Top ``nev`` eigenpairs of the float64 gram X^T X / p, formed on the
    card from the packed bytes (p x p, 20 GB at the tall headline) and
    solved by the port's block Lanczos in float64 to tol 1e-12.  With a
    ``depth`` below p, also those of the first ``depth`` SNPs' gram
    X_d^T X_d / depth, which is p / depth times the leading block of
    the same matrix, solved the same way.  Returns (the full gram's,
    the leading block's or None)."""
    import torch

    from flashpca_tpu_torch.ops.genotypes import decode_standardized
    from flashpca_tpu_torch.ops.standardize import lookup_tables

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
    res = f64_eigsh(G, nev)
    cut = None
    if depth is not None and depth < p:
        Gd = G[:depth, :depth] * (p / depth)
        del G
        cut = f64_eigsh(Gd, nev)
    return res, cut


def float64_depth(top, budget_s=None, passes=None):
    """The SNP depth of the tall headline's float64 ``pca()``: the whole
    of it unless one float64 gram pass (the functional core on the card,
    timed here at full depth) times ``passes`` would exceed
    ``budget_s``; else the largest multiple of 1,024 SNPs that fits,
    the pass taken to scale with the depth.  Returns (depth, the full
    pass's seconds)."""
    import torch

    from flashpca_tpu_torch import TallPackedOperator

    budget_s = F64_SOLVE_S if budget_s is None else budget_s
    passes = F64_PASSES if passes is None else passes
    p = top.n_snps
    op = TallPackedOperator(top.packed, top.center, top.scale, top.n_samples,
                            device=top.device, dtype=torch.float64,
                            snp_sumsq=top.snp_sumsq)
    gen = torch.Generator(device=top.device).manual_seed(4)
    v = torch.randn((p, 16), dtype=torch.float64, device=top.device,
                    generator=gen)
    sync()
    t0 = time.perf_counter()
    op.gram_permuted(v)
    sync()
    pass_s = time.perf_counter() - t0
    del op, v
    depth = p
    if passes * pass_s > budget_s:
        depth = min(p, max(1024, int(budget_s / (passes * pass_s) * p)
                           // 1024 * 1024))
    say(f"   one float64 gram pass at {p} SNPs: {pass_s:.2f} s; x "
        f"{passes} passes = {passes * pass_s:.0f} s against {budget_s:.0f} "
        f"s: depth {depth} SNPs (all {top.n_samples} samples)")
    return depth, pass_s


def tall_float64(top, k, depth, ref):
    """The tall headline at float64: ``pca(TallPackedOperator(...,
    dtype=float64), k)`` on the first ``depth`` SNPs of the resident
    tall bytes and all their samples, through the functional core on the
    card (counts set to 0 just before and read just after: no kernel may
    launch), its eigenvalues held to the float64 eigendecomposition
    ``ref`` of that gram within EIG_BAR of the largest for every pair,
    the bulk included.  Returns a summary."""
    import torch

    from flashpca_tpu_torch import TallPackedOperator, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    op = TallPackedOperator(top.packed[:depth], top.center[:depth],
                            top.scale[:depth], top.n_samples,
                            device=top.device, dtype=torch.float64,
                            snp_sumsq=top.snp_sumsq[:depth])
    tpk.reset_launch_counts()
    with Phase(f"tall pca(op, {k}) float64, {depth} SNPs x "
               f"{top.n_samples} samples") as ph:
        res = pca(op, k, maxiter=F64_MAXITER)
    launches = dict(tpk.launch_counts)
    del op
    d_ref = ref.eigenvalues[:k]
    err = np.abs(res.values - d_ref) / d_ref[0]
    say(f"   float64 tall: n_ops {res.n_ops}, n_restarts {res.n_restarts}, "
        f"converged {res.converged}, wall {ph.seconds:.2f} s, largest gap "
        f"to the float64 reference {err.max():.2e} of the largest (bar "
        f"{EIG_BAR}); reference: {ref.n_ops} passes, converged "
        f"{ref.converged}; kernel launches {sum(launches.values())}")
    say("   d_f64 " + " ".join(f"{x:.6f}" for x in res.values))
    say("   d_ref " + " ".join(f"{x:.6f}" for x in d_ref))
    ran = [nm for nm, c in launches.items() if c]
    if ran:
        raise AssertionError(f"float64 tall headline launched kernels {ran}")
    if not (ref.converged and res.converged and err.max() <= EIG_BAR):
        raise AssertionError(
            f"float64 tall headline: eigenvalues "
            f"{np.flatnonzero(err > EIG_BAR)} off the float64 reference "
            f"beyond {EIG_BAR} of the "
            f"largest (max {err.max():.2e}; converged {res.converged}, "
            f"reference {ref.converged})")
    return {"depth": depth, "n_ops": res.n_ops, "n_restarts": res.n_restarts,
            "pca_s": ph.seconds, "eig_err_of_largest": float(err.max()),
            "ref_n_ops": ref.n_ops}


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
    require_no_first_design(launches, "tall path")

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
        f"converged {res.converged}, check mse {chk.mse!r}; wide: n_ops "
        f"{res_w.n_ops}, gate mse {res_w.gate_mse!r}, check mse "
        f"{chk_w.mse!r}")
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
    if res.n_ops != 32:
        raise AssertionError(f"tall headline: n_ops {res.n_ops}, not 32 "
                             "(the JAX package's tall bench: 40, on its own "
                             "data)")
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               check_mse=chk.mse, wide_n_ops=res_w.n_ops,
               wide_gate_mse=res_w.gate_mse, wide_check_mse=chk_w.mse,
               eig_err_of_largest=eig_err, min_abs_cos=float(cos.min()),
               launches=launches, launch_ms=launch_ms)
    with Phase("one float64 gram pass: the float64 run's SNP depth"):
        depth, f64_pass_s = float64_depth(top)
    with Phase("float64 reference: X^T X / p on the card, eigsh") as ph:
        ref, ref_cut = f64_reference(top, k + 8, depth=depth)
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
    out["float64"] = dict(tall_float64(top, k, depth, ref_cut or ref),
                          gram_pass_s=f64_pass_s)
    return top, out, res


# the streamed tall crossprod z = X^T x: a vector and a 16-column panel;
# each column within CROSSPROD_BAR of its largest |z| of the float64
# product on the first CROSSPROD_F64_ROWS SNP rows and of the resident
# wide operator's z on all rows (its blocks summed in another order)
TALL_CROSSPROD_KS = (1, 16)
CROSSPROD_BAR = 2e-5
CROSSPROD_F64_ROWS = 512


def column_max_err(got, ref):
    """Largest over columns of max |got - ref| / max |ref| (float64)."""
    got = got.double().reshape(ref.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1)
    return float(((got - ref).abs().amax(0) / ref.abs().amax(0)).max())


def require_counts(launches, want, what):
    """Every kernel's launches equal to ``want``'s (0 where unnamed)."""
    bad = {nm: c for nm, c in launches.items() if c != want.get(nm, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {bad}, expected {want}")


def tall_crossprod(dev, host, center, scale, n, memory_mb, seed=19,
                   ks=TALL_CROSSPROD_KS, f64_rows=CROSSPROD_F64_ROWS):
    """TallStreamingOperator.crossprod on the streamed tall headline's
    bytes under ``memory_mb`` (B1 on each staged block of samples, the
    partials summed in block order): a seeded (N,) vector and a seeded
    (N, 16) panel.  Counts set to 0 just before each call, read just
    after: B1 once a staged block, nothing else.  Each column held to
    float64 on the first ``f64_rows`` SNP rows and to the resident wide
    operator's crossprod on the same bytes (rebuilt from the host bytes
    once the streaming operator's buffers are freed), within
    CROSSPROD_BAR of its largest |z|.  Returns {k: its summary}."""
    import torch

    from flashpca_tpu_torch import PackedOperator, TallStreamingOperator
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.ops.genotypes import permute_samples

    p, nbytes = host.shape
    op = TallStreamingOperator(host, center, scale, n, memory_mb=memory_mb,
                               cache_mb=0, device=dev)
    lut6 = tpk.lut_rows(*op._ff_luts())[:, :f64_rows].contiguous()
    head = torch.from_numpy(np.ascontiguousarray(host[:f64_rows])).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    xs, zs, out = {}, {}, {}
    for k in ks:
        x = torch.randn((n, k), generator=g, device=dev)
        xs[k] = x[:, 0] if k == 1 else x
        tpk.reset_launch_counts()
        with tpk.time_launches() as log:
            with Phase(f"tall streamed crossprod of an (N, {k}) "
                       f"{'vector' if k == 1 else 'panel'}, memory_mb="
                       f"{memory_mb}") as ph:
                z = op.crossprod(xs[k])
        launches = dict(tpk.launch_counts)
        by_kc = launches_by_kc(log)
        launch_ms = launch_medians(log)
        z64 = f64_product(head, lut6, permute_samples(x.double(), nbytes),
                          transpose=False, rows=128)
        zs[k] = z.reshape(p, k)
        # a vector takes B1's one-column kernel
        b1 = "crossprod_narrow" if k == 1 else "crossprod"
        out[k] = {"wall_s": ph.seconds, "launches": launches[b1],
                  "launches_by_kc": by_kc, "launch_ms": launch_ms,
                  "f64_err": column_max_err(zs[k][:f64_rows], z64)}
        say(f"   k={k}: {launches[b1]} B1 launches "
            f"({op.n_blocks} blocks), by kc {json.dumps(by_kc)}; each "
            f"column within {out[k]['f64_err']:.2e} of its largest |z| of "
            f"float64 on the first {f64_rows} SNPs")
        require_counts(launches, {b1: op.n_blocks},
                       f"tall streamed crossprod k={k}")
        if not (z.shape == ((p,) if k == 1 else (p, k))
                and bool(torch.isfinite(z).all())):
            raise AssertionError(f"tall streamed crossprod k={k}: "
                                 "non-finite or misshapen z")
    op.close()
    del op, head
    torch.cuda.empty_cache()
    with Phase("the resident wide operator's crossprod on the same "
               "bytes") as ph:
        wide = PackedOperator(host, center, scale, n, device=dev)
        for k in ks:
            out[k]["wide_err"] = column_max_err(
                zs[k], wide.crossprod(xs[k]).reshape(p, k))
        del wide
    torch.cuda.empty_cache()
    say("   the streamed z against the resident wide operator's, of each "
        "column's largest: " + ", ".join(f"k={k} {o['wide_err']:.2e}"
                                         for k, o in out.items()))
    for k, o in out.items():
        if not (o["f64_err"] <= CROSSPROD_BAR
                and o["wide_err"] <= CROSSPROD_BAR):
            raise AssertionError(
                f"tall streamed crossprod k={k}: {o['f64_err']:.2e} off "
                f"float64, {o['wide_err']:.2e} off the resident wide "
                f"operator (bar {CROSSPROD_BAR} of each column's largest)")
    out["wide_s"] = ph.seconds
    return out


def streamed_tall_headline(dev, host, center, scale, sumsq, resident,
                           resident_check_mse, resident_launch_ms,
                           memory_mb=STREAM_MEMORY_MB):
    """The tall headline job under the same 2 GB bound: its bytes, copied
    to the host after the resident tall phase, streamed in blocks of
    samples by a TallStreamingOperator with two device block buffers of
    ``memory_mb`` MB in all and no block cache.  Counts set to 0 just
    before ``pca(op, k)`` and read just after: B1, B2, B3 and B5 must
    have launched, no first design.  Then ``check()`` of the result
    through a StreamingPackedOperator over the same host bytes at the
    same bound, the tall operator's buffers released first, so the
    whole job stays under it.  Held to the resident tall run
    ``resident`` (its PCAResult): the same ``n_ops``, check mse < 1e-8
    and within max(1e-8, 2 x ``resident_check_mse``), eigenvalues within
    EIG_BAR of the largest, every vector by the TWIN_NEAR rule
    (:func:`twin_cosines`), the packed bytes on the device within
    ``memory_mb``.  Then the operator's crossprod (:func:`tall_crossprod`,
    B1 once a block).  Then B1, B2, B3 and B5 held to their plain
    versions and timed on one resident block of the streamed shape, and
    B1 at the crossprod's two widths.  Returns (the kernels rows of the
    block shape, a summary)."""
    import torch

    from flashpca_tpu_torch import (StreamingPackedOperator,
                                    TallPackedOperator,
                                    TallStreamingOperator, check, pca)
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    n, k = resident.vectors.shape
    op = TallStreamingOperator(host, center, scale, n, memory_mb=memory_mb,
                               cache_mb=0, device=dev, snp_sumsq=sumsq)
    st = op.stats()
    last = op.nbytes - op._bounds(op.n_blocks - 1)[0]
    say(f"   {op.n_blocks} blocks of {op.block_bytes} bytes "
        f"({4 * op.block_bytes} samples, {st['block_bytes'] / 1e9:.3f} GB "
        f"each; the last {last} bytes) of {st['packed_bytes'] / 1e9:.2f} GB "
        f"on the host, prefetch default {op._prefetch}")
    out = {"memory_mb": memory_mb, "n_blocks": op.n_blocks,
           "block_bytes": op.block_bytes, "last_block_bytes": last,
           "block_nbytes": st["block_bytes"], "prefetch": op._prefetch}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the streamed tall path: counts set to 0 just before pca(), read
    # just after; B1, B2, B3 and B5 must have launched
    tpk.reset_launch_counts()
    with tpk.time_launches() as log:
        with Phase(f"streamed tall pca(op, {k}) polish='contract' float32, "
                   f"memory_mb={memory_mb}") as ph:
            res = pca(op, k, polish="contract")
    launches = dict(tpk.launch_counts)
    out["pca_s"] = wall = ph.seconds
    sync()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    st = op.stats()
    passes = st["staged_host_blocks"] / op.n_blocks
    busy, _ = busy_and_span(log)
    launch_ms = launch_medians(log)
    op.close()
    del op
    torch.cuda.empty_cache()
    wop = StreamingPackedOperator(host, center, scale, n,
                                  memory_mb=memory_mb, cache_mb=0,
                                  device=dev, snp_sumsq=sumsq)
    with Phase(f"check() through the wide streaming operator, memory_mb="
               f"{memory_mb}") as ph:
        chk = check(wop, res.vectors, res.values)
    out["check_s"] = ph.seconds
    check_bytes = wop.stats()["device_bytes"]
    wop.close()
    del wop
    torch.cuda.empty_cache()
    crossprod = tall_crossprod(dev, host, center, scale, n, memory_mb)
    out["tall_crossprod"] = {str(key): val for key, val in crossprod.items()}

    d, d_r = res.values, resident.values
    eig_err = np.abs(d - d_r) / d_r[0]
    cos, held, clusters = twin_cosines(res.vectors, resident.vectors, d_r,
                                       TWIN_NEAR * d_r[0])
    say(f"   n_ops {res.n_ops} (resident {resident.n_ops}), n_restarts "
        f"{res.n_restarts}, converged {res.converged}, check mse "
        f"{chk.mse!r} (resident {resident_check_mse!r})")
    say(f"   pca wall {wall:.2f} s, check wall {out['check_s']:.2f} s, peak "
        f"device memory of the pca {out['peak_gb']:.2f} GB, packed bytes on "
        f"the device {st['device_bytes']} (the check's {check_bytes}; bound "
        f"{memory_mb << 20})")
    say(f"   stats {json.dumps(st)}")
    say(f"   {passes:.0f} passes, {st['staged_bytes'] / 1e9:.2f} GB streamed,"
        f" {st['staged_bytes'] / wall / 1e9:.2f} packed GB/s over the pca "
        f"wall; per pass fill {st['fill_s'] / passes:.3f} s ("
        f"{st['staged_bytes'] / st['fill_s'] / 1e9:.2f} GB/s), put "
        f"{st['put_s'] / passes:.3f} s, sync {st['sync_s'] / passes:.3f} s,"
        f" wait {st['wait_s'] / passes:.3f} s; B1, B2, B3, B5 busy "
        f"{busy:.2f} s ({busy / wall:.1%} of the wall)")
    say("   per-launch medians beside the resident tall headline's: "
        + ", ".join(f"{key} {ms:.2f} ({resident_launch_ms.get(key, 0):.2f})"
                    for key, ms in sorted(launch_ms.items())))
    say("   eigenvalues vs resident, of the largest: "
        + " ".join(f"{e:.1e}" for e in eig_err))
    say("   |cos| with the resident vectors: "
        + " ".join(f"{c:.8f}" for c in cos))
    say(f"   pairs closer than {TWIN_NEAR} of the largest: {clusters}; "
        "|cos|, or the pair's largest principal angle's cosine: "
        + " ".join(f"{c:.8f}" for c in held))
    out.update(n_ops=res.n_ops, n_restarts=res.n_restarts,
               check_mse=chk.mse, stats=st, passes=passes,
               streamed_gb=st["staged_bytes"] / 1e9,
               packed_gb_s=st["staged_bytes"] / wall / 1e9,
               fill_gb_s=st["staged_bytes"] / st["fill_s"] / 1e9,
               busy_s=busy, busy_share=busy / wall,
               check_device_bytes=check_bytes,
               launches={nm: launches[nm] for nm in TALL_PATH},
               launch_ms=launch_ms,
               eig_err_of_largest=float(eig_err.max()),
               min_abs_cos=float(cos.min()), min_span_cos=float(held.min()),
               clusters=clusters)
    require_launched(launches, TALL_PATH, "streamed tall headline")
    require_no_first_design(launches, "streamed tall headline")
    if not (res.vectors.shape == (n, k) and np.isfinite(res.vectors).all()
            and np.isfinite(res.values).all()):
        raise AssertionError("streamed tall headline: non-finite or "
                             "misshapen result")
    if res.n_ops != resident.n_ops:
        raise AssertionError(f"streamed tall headline: n_ops {res.n_ops}, "
                             f"resident {resident.n_ops}")
    if not chk.mse < 1e-8 or not chk.mse <= max(1e-8,
                                                 2.0 * resident_check_mse):
        raise AssertionError(
            f"streamed tall headline: check mse {chk.mse:.3e} (resident "
            f"{resident_check_mse:.3e})")
    if not eig_err.max() <= EIG_BAR:
        raise AssertionError(
            f"streamed tall headline: eigenvalues {eig_err.max():.2e} of "
            f"the largest off the resident run (bar {EIG_BAR})")
    bad = (cos < 1 - 1e-6) & (held < 1 - 1e-6)
    if bad.any():
        raise AssertionError(
            f"streamed tall headline: vectors {np.flatnonzero(bad)} off the "
            f"resident ones (|cos| {cos[bad]}, their clusters' spans "
            f"{held[bad]})")
    if dev.type == "cuda" and not (0 < st["device_bytes"] <= memory_mb << 20
                                   and 0 < check_bytes <= memory_mb << 20):
        raise AssertionError(
            f"streamed tall headline: {st['device_bytes']} packed bytes on "
            f"the device ({check_bytes} in the check), bound {memory_mb} MiB")

    # B1, B2, B3 and B5 at the streamed block's shape, on one block held
    # resident (its samples are the block's 4 x block_bytes)
    bb = out["block_bytes"]
    with Phase(f"kernel times on one {host.shape[0]} x {bb}-byte block"):
        bop = TallPackedOperator(np.ascontiguousarray(host[:, :bb]), center,
                                 scale, 4 * bb, device=dev)
        rows = time_kernels(bop, [("crossprod", 16), ("crossprod", 32),
                                  ("matvec", 16), ("crossprod_ff", 32),
                                  ("matvec_ff_novl", 32)],
                            launches, None, slices=8)
        # crossprod's B1 at the vector's width (its one-column kernel)
        # and the panel's
        cp_names = {k: "crossprod_narrow" if k == 1 else "crossprod"
                    for k in TALL_CROSSPROD_KS}
        cp_rows = [row for k in TALL_CROSSPROD_KS for row in time_kernels(
            bop, [(cp_names[k], k)],
            {cp_names[k]: crossprod[k]["launches"]}, None, slices=8)]
        del bop
    for row in rows:
        row.update(path="tall_streaming",
                   stream_launch_ms=launch_ms.get(f"{row['name']}/"
                                                  f"{row['k']}"))
    for row in cp_rows:
        # a call launches B1 at one width: its log has one median
        row.update(path="tall_crossprod", stream_launch_ms=next(
            iter(crossprod[row["k"]]["launch_ms"].values()), None))
    return rows + cp_rows, out


# ---------------------------------------------------------------------------
# Phase 5, end: kernel times at the headline shapes
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
            "crossprod_narrow": lambda x=x: (
                lambda: tpk.crossprod_p(pk, m, iv, x),
                lambda: tpk.crossprod_plain(pk, m, iv, x),
                lambda sl, Wh, Wl: [lambda: Wh @ x], False,
                p * nb + n4 * k * 4 + 3 * p * 4 + p * k * 4),
            "matvec_narrow": lambda v=v: (
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


def plain_err(tag, got, plain, length):
    """Max abs err of a kernel's result against its plain version's on
    the same inputs, held under ``plain_bar(length)`` (two-float pairs
    by their hi halves, as :func:`hold`)."""
    if isinstance(got, tuple):
        got, plain = got[0], plain[0]
    return close(tag, got, plain, *plain_bar(length))


def time_kernels(op, widths, launches, worst, slices):
    """One row of the ``kernels`` JSON per (kernel, k) in ``widths``,
    timed at ``op``'s shapes: kernel, plain version and torch.matmul on
    the same block decoded to float32 (decode untimed, ``slices`` SNP
    slices), beside the bound.  ``worst`` gives each row's max abs err
    against the plain version; None measures it here, on these
    inputs."""
    p, nb = op.packed.shape
    rows = []
    for (name, k), (kern, plain, lib, ff, nbytes) in kernel_specs(
            op, widths).items():
        if worst is None:
            length = p if name.startswith("matvec") else 4 * nb
            err = plain_err(f"{name} k={k} on {p} x {4 * nb}", kern(),
                            plain(), length)
        else:
            err = worst[name]
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
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "k": k, "shape": [p, 4 * nb],
        })
    return rows


def scca_rows(op, solo, grid, rows, suffix, slices, ndim=SCCA_NDIM):
    """The kernels rows of SCCA on ``op``'s shape: B1 and B2 on the one
    column of a solo run (their one-column kernels) and, where the solo
    runs launched it, B2 at kc 8 on their ``ndim`` columns (Px = X U),
    timed and held to their plain versions on it, with the solo runs'
    launches ``solo``; and the grid's: the kc 16 B1 and B2 rows among
    ``rows`` (16 cells are the same work as those rows' 16 columns) with
    the grid's launches ``grid``.  Paths "scca" and "scca_grid", each
    plus ``suffix``."""
    widths = [("crossprod_narrow", 1), ("matvec_narrow", 1)]
    if solo.get("matvec"):
        widths.append(("matvec", ndim))
    out = [dict(row, path="scca" + suffix)
           for row in time_kernels(op, widths, solo, None, slices)]
    for row in rows:
        if row["name"] in SCCA_GRID_PATH and row["k"] == 16:
            row = {k: v for k, v in row.items() if k != "stream_launch_ms"}
            out.append(dict(row, launches=grid[row["name"]],
                            path="scca_grid" + suffix))
    return out


def time_turns(fns, kc, out):
    """Time each of ``fns`` ({name: thunk}, one function on the same
    inputs) in turns: each in order, then each in reverse order, one
    median of 5 launches after a warm-up per turn; add {"name/kc": [ms,
    ms]} to ``out``."""
    times = {}
    for name in list(fns) + list(fns)[::-1]:
        times.setdefault(name, []).append(event_ms(fns[name], reps=5))
    for name, ts in times.items():
        say(f"   {name:24s} kc={kc}: " + ", ".join(f"{t:.2f}" for t in ts)
            + " ms (turns)")
        out[f"{name}/{kc}"] = ts
    return out


def time_novl(op, kcs):
    """B5 beside its comparison entries (C = 4, CR = 128, the first
    design) at ``op``'s shapes, on the same inputs, in turns.  Returns
    {"name/kc": [ms, ms]}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    g = torch.Generator(device=op.device).manual_seed(98)
    pk = op.packed
    lut6 = tpk.lut_rows(*op._ff_luts())
    out = {}
    for kc in kcs:
        v = torch.randn((pk.shape[0], kc), generator=g, device=op.device)
        time_turns({name: (lambda f=getattr(tpk, name + "_p"):
                           f(pk, lut6, v))
                    for name in ("matvec_ff_novl",) + tpk.NOVL_KERNELS},
                   kc, out)
        del v
    return out


def time_b1(op, kcs):
    """B1 beside its first design at ``op``'s shapes, on the same
    inputs, in turns.  Returns {"name/kc": [ms, ms]}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    g = torch.Generator(device=op.device).manual_seed(97)
    pk, m, iv = op.packed, op.mean, op.invsd
    out = {}
    for kc in kcs:
        x = torch.randn((4 * pk.shape[1], kc), generator=g, device=op.device)
        time_turns({name: (lambda f=getattr(tpk, name + "_p"):
                           f(pk, m, iv, x))
                    for name in ("crossprod",) + tpk.B1_KERNELS}, kc, out)
        del x
    return out


def time_b2(op, kcs):
    """B2 beside its first design at ``op``'s shapes, on the same
    inputs, in turns.  Returns {"name/kc": [ms, ms]}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    g = torch.Generator(device=op.device).manual_seed(95)
    pk, m, iv = op.packed, op.mean, op.invsd
    out = {}
    for kc in kcs:
        v = torch.randn((pk.shape[0], kc), generator=g, device=op.device)
        time_turns({name: (lambda f=getattr(tpk, name + "_p"):
                           f(pk, m, iv, v))
                    for name in ("matvec",) + tpk.B2_KERNELS}, kc, out)
        del v
    return out


def time_b3(op, kcs):
    """B3 beside its first design at ``op``'s shapes, on the same
    inputs, in turns.  Returns {"name/kc": [ms, ms]}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    g = torch.Generator(device=op.device).manual_seed(96)
    pk = op.packed
    lut6 = tpk.lut_rows(*op._ff_luts())
    out = {}
    for kc in kcs:
        x = torch.randn((4 * pk.shape[1], kc), generator=g, device=op.device)
        time_turns({name: (lambda f=getattr(tpk, name + "_p"):
                           f(pk, lut6, x))
                    for name in ("crossprod_ff",) + tpk.B3_KERNELS}, kc, out)
        del x
    return out


def time_b4(op, kcs):
    """B4 beside its first design at ``op``'s shapes, on the same
    inputs, in turns.  Returns {"name/kc": [ms, ms]}."""
    import torch

    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    g = torch.Generator(device=op.device).manual_seed(94)
    pk = op.packed
    lut6 = tpk.lut_rows(*op._ff_luts())
    out = {}
    for kc in kcs:
        v = torch.randn((pk.shape[0], kc), generator=g, device=op.device)
        vl = torch.randn((pk.shape[0], kc), generator=g, device=op.device)
        vl *= 1e-7
        time_turns({name: (lambda f=getattr(tpk, name + "_p"):
                           f(pk, lut6, v, vl))
                    for name in ("matvec_ff",) + tpk.B4_KERNELS}, kc, out)
        del v, vl
    return out


def with_first_designs(rows, firsts, launches, worst):
    """``rows`` with each row of a kernel in ``firsts`` ({kernel: (first
    design, its turns)}) whose first design was timed at the row's kc
    marked as the current design, beside a row of that first design: the
    same function at the same shape, so the bound, plain and library
    times are the current row's; its own time the median of its turns,
    and its launches on the main path (0)."""
    out = []
    for row in rows:
        kc = next(w for w in (8, 16, 24, 32) if w >= row["k"])
        name, turns = firsts.get(row["name"], (None, {}))
        if f"{name}/{kc}" not in turns:
            out.append(row)
            continue
        out += [dict(row, design="current"),
                dict(row, name=name, source=SOURCE[name],
                     replaces=TPU_KERNEL[name], launches=launches[name],
                     max_abs_err=worst[name],
                     ms=float(np.median(turns[f"{name}/{kc}"])),
                     design="first")]
    return out


# ---------------------------------------------------------------------------
# Phase 6: the kernel sweep (V1-V4 and the tile axis)
# ---------------------------------------------------------------------------

def kernel_sweep(dev, p, n, worst, b1_library_ms, main_launches,
                 split3_sass_ops):
    """The sweep tool's five steps at p x n, k = SWEEP_K, then the plain
    versions of V1-V4 timed at that shape (their first designs share
    them); V1-V4 must be bit-equal to their first designs there.  One row
    of the ``kernels`` JSON per variant and first design (library_ms:
    B1's torch.matmul time at the same shape, passed in, since it
    computes the same z = W x; launches: the sweep's, beside the main
    path's ``main_launches``; ms: the mean of its two turn medians,
    beside B1's and the difference).  V3's bound, and its first
    design's, is the largest of its tensor-core products, its bytes and
    the CUDA-core work the function needs
    (:func:`split3_needed_ops_per_genotype`); each row also carries its
    design's own CUDA-core instructions a genotype and their time at the
    CUDA-core rate: ``split3_sass_ops`` (V3's SASS reading), or
    SPLIT3_OPS_PER_GENOTYPE for the first design.  Returns (rows, the
    sweep's readings)."""
    import torch

    from flashpca_tpu_torch.kernels import crossprod_variants as cv
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.tools import kernel_sweep as ks

    nb, k = (n + 3) // 4, SWEEP_K
    n4 = 4 * nb
    with Phase(f"kernel sweep: {p} x {n4}, k={k}") as ph:
        # the sweep's launches: counts set to 0 just before, read just
        # after (none of these kernels is on the main path)
        tpk.reset_launch_counts()
        out, data = ks.run(p, nb, k, dev)
        launches = dict(tpk.launch_counts)
        require_launched(launches, SWEEP_PATH, "kernel sweep")
        for name, rel in out["correctness"].items():
            if not rel < F64_BAR[name]:
                raise AssertionError(f"sweep: {name} vs B1 rel {rel:.2e} "
                                     f"(bar {F64_BAR[name]})")
        unequal = [nm for nm, eq in out["first_designs_equal"].items()
                   if not eq]
        if unequal:
            raise AssertionError(f"sweep: redesigns not bit-equal to "
                                 f"{unequal} at {p} x {n4}")
        pk, m, iv, xp = (data[key] for key in ("packed", "mean", "invsd",
                                               "xp"))
        t_bytes = ((p * nb + n4 * k * 4 + 3 * p * 4 + p * k * 4)
                   / PEAK_BYTES_S * 1e3)
        timed = out["variants"]
        rows, plain_times = [], {}
        for name in VARIANTS + VARIANT_FIRSTS:
            # a first design's plain version is its redesign's, timed
            # just before
            base = name.removesuffix("_v1")
            if base not in plain_times:
                plain = cv.VARIANTS[base][1]
                plain_times[base] = ks.event_ms(
                    lambda: plain(pk, m, iv, xp), reps=1)
            plain_ms = plain_times[base]
            if base == "crossprod_split3":
                ops = split3_needed_ops_per_genotype(k)
                own = (split3_sass_ops if name == base
                       else SPLIT3_OPS_PER_GENOTYPE)
                own_ms = own * p * n4 / PEAK_FP32_INSTR * 1e3
                t_ops = max(
                    SPLIT3_BF16_DOTS * 2.0 * k * p * n4 / PEAK_BF16_FLOPS,
                    ops * p * n4 / PEAK_FP32_INSTR) * 1e3
            else:
                t_ops = 2.0 * DOTS[name] * k * p * n4 / PEAK_FP32_FLOPS * 1e3
            bound = max(t_ops, t_bytes)
            ms = timed["ms"][name]
            say(f"   {name:20s} k={k}: kernel {ms:.2f} ms (B1 "
                f"{timed['ms']['crossprod']:.2f} ms, difference "
                f"{timed['minus_b1_ms'][name]:+.2f} ms), plain "
                f"{plain_ms:.2f} ms, torch.matmul (B1's) {b1_library_ms:.2f}"
                f" ms, bound {bound:.2f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
                f"{launches[name]} sweep launches, {main_launches[name]} on "
                "the main path"
                + (f"; its own {own:.3f} CUDA-core instructions a genotype "
                   f"would take {own_ms:.2f} ms, the function needs {ops:.3f}"
                   if base == "crossprod_split3" else ""))
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": TPU_KERNEL[name], "launches": launches[name],
                "launches_from": "kernel sweep",
                "main_path_launches": main_launches[name],
                "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": b1_library_ms, "k": k, "shape": [p, n4],
                "b1_ms": timed["ms"]["crossprod"],
                "minus_b1_ms": timed["minus_b1_ms"][name],
                **({"design": "first"} if name in VARIANT_FIRSTS else {}),
                **({"ops_per_genotype": ops, "own_ops_per_genotype": own,
                    "own_ops_ms": own_ms}
                   if base == "crossprod_split3" else {}),
            })
        del data, pk, m, iv, xp
    out.update(launches={nm: launches[nm] for nm in SWEEP_PATH},
               seconds=ph.seconds)
    return rows, out


# ---------------------------------------------------------------------------
# Sharding (flashpca_tpu_torch.parallel): one process, two shards on the
# card; and two processes with torch.distributed
# ---------------------------------------------------------------------------

def card_mesh(dev, shards, axis="snps"):
    """A one-process mesh of ``shards`` shards on ``dev``'s card."""
    import torch

    from flashpca_tpu_torch.parallel import snp_mesh

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return snp_mesh([f"cuda:{idx}"] * shards, axis_name=axis)


def hold_sharded(tag, res, chk, ref, ref_check_mse, launches, path):
    """A sharded run ``res`` (its check ``chk``) against the one-shard
    run ``ref`` on the same bytes: every eigenvalue within SHARD_EIG_BAR
    relative, check mse < max(1e-8, 2 x the one-shard run's), every
    kernel of ``path`` launched and no first design; ``n_ops`` and the
    gate's mse printed beside the one-shard run's (the float32 gate sits
    near its bar, and the shards' order of sums may flip it: said, not
    failed)."""
    rel = np.abs(res.values - ref.values) / ref.values
    say(f"   {tag}: n_ops {res.n_ops} (one shard {ref.n_ops}), gate mse "
        f"{res.gate_mse!r} (one shard {ref.gate_mse!r}), check mse "
        f"{chk.mse!r} (one shard {ref_check_mse!r}); eigenvalues vs one "
        f"shard rel err max {rel.max():.2e} (bar {SHARD_EIG_BAR})")
    if res.n_ops != ref.n_ops:
        say(f"   {tag}: the contract gate FLIPPED: n_ops {res.n_ops} "
            f"against the one-shard run's {ref.n_ops}")
    require_launched(launches, path, tag)
    require_no_first_design(launches, tag)
    if not (np.isfinite(res.vectors).all() and np.isfinite(res.values).all()
            and res.vectors.shape == ref.vectors.shape):
        raise AssertionError(f"{tag}: non-finite or misshapen result")
    if not rel.max() <= SHARD_EIG_BAR:
        raise AssertionError(f"{tag}: eigenvalues {rel.max():.2e} relative "
                             f"off the one-shard run (bar {SHARD_EIG_BAR})")
    if not chk.mse < max(1e-8, 2.0 * ref_check_mse):
        raise AssertionError(f"{tag}: check mse {chk.mse:.3e}")
    return {"n_ops": res.n_ops, "gate_mse": res.gate_mse,
            "check_mse": chk.mse, "one_shard_n_ops": ref.n_ops,
            "one_shard_gate_mse": ref.gate_mse,
            "eig_rel_err": float(rel.max()),
            "launches": {nm: launches[nm] for nm in path}}


def sharded_headline(dev, op, res, head, worst, k):
    """The wide headline's bytes on a 2-shard mesh of the card: row views
    of the resident tensor (no copy), ``pca(op, k)`` (contract, float32)
    and ``check()`` with the counts set to 0 just before and read just
    after (B1-B4 must launch), held to the one-shard run by
    :func:`hold_sharded`; then B1 and B2 at kc 16 timed at one shard's
    shape.  Returns (kernel rows, summary)."""
    from flashpca_tpu_torch import PackedOperator, check, pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    sop = PackedOperator(op.packed, op.center, op.scale, op.n_samples,
                         mesh=card_mesh(dev, SHARDS),
                         snp_sumsq=op.snp_sumsq)
    base, row = op.packed.data_ptr(), op.packed.shape[1]
    if any(blk.data_ptr() != base + lo * row for blk, lo, _ in sop._shards):
        raise AssertionError("sharded headline: a shard is not a row view")
    tpk.reset_launch_counts()
    with Phase(f"sharded headline: pca(op, {k}) on {SHARDS} shards of "
               "the card") as ph:
        res2 = pca(sop, k)
    with Phase("check(sharded op, U, d)") as ph2:
        chk2 = check(sop, res2.vectors, res2.values)
    launches = dict(tpk.launch_counts)
    out = hold_sharded("sharded headline", res2, chk2, res,
                       head["check_mse"], launches, WIDE_PATH)
    out.update(pca_s=ph.seconds, check_s=ph2.seconds,
               one_shard_pca_s=head["pca_s"])
    lo, hi = sop._shards[0][1:]
    shard = PackedOperator(op.packed[lo:hi], op.center[lo:hi],
                           op.scale[lo:hi], op.n_samples, device=op.device,
                           snp_sumsq=op.snp_sumsq[lo:hi])
    del sop
    with Phase("kernel times at one shard's shape"):
        rows = [dict(r, path="sharded") for r in time_kernels(
            shard, [("crossprod", 16), ("matvec", 16)], launches, worst,
            slices=16)]
    return rows, out


def sharded_tall(dev, top, res, tall, worst, k):
    """The tall headline's bytes on 2 byte-column shards of the card
    (each shard a contiguous copy of its columns): ``pca(op, k)``, then
    ``check()`` of its result through a 2-shard wide operator on the
    same bytes (row views), counts around both (B1, B2, B3, B5 must
    launch), held to the one-shard tall run by :func:`hold_sharded`;
    then B1 and B2 at kc 16 timed at one shard's shape.  Returns (kernel
    rows, summary)."""
    from flashpca_tpu_torch import PackedOperator, TallPackedOperator, check
    from flashpca_tpu_torch import pca
    from flashpca_tpu_torch.kernels import packed_matvec as tpk

    with Phase(f"sharded tall: {SHARDS} byte-column shards on the card"):
        stop = TallPackedOperator(top.packed, top.center, top.scale,
                                  top.n_samples,
                                  mesh=card_mesh(dev, SHARDS, "samples"),
                                  snp_sumsq=top.snp_sumsq)
    wide = PackedOperator(top.packed, top.center, top.scale, top.n_samples,
                          mesh=card_mesh(dev, SHARDS),
                          snp_sumsq=top.snp_sumsq)
    tpk.reset_launch_counts()
    with Phase(f"sharded tall pca(op, {k})") as ph:
        res2 = pca(stop, k)
    with Phase("check() through the 2-shard wide operator"):
        chk2 = check(wide, res2.vectors, res2.values)
    launches = dict(tpk.launch_counts)
    del wide
    out = hold_sharded("sharded tall", res2, chk2, res, tall["check_mse"],
                       launches, TALL_PATH)
    out.update(pca_s=ph.seconds, one_shard_pca_s=tall["pca_s"])
    blk = stop._shards[0][0]
    shard = TallPackedOperator(blk, top.center, top.scale, 4 * blk.shape[1],
                               device=top.device)
    del stop
    with Phase("kernel times at one tall shard's shape"):
        rows = [dict(r, path="sharded_tall") for r in time_kernels(
            shard, [("crossprod", 16), ("matvec", 16)], launches, worst,
            slices=16)]
    return rows, out


def mp_modes(root, dev, mesh=None, tmesh=None):
    """The two-process phase's runs on the mid-size fileset: in one
    process on ``dev`` (``mesh`` None), or in each process of the group
    on its shard of ``mesh`` (wide) and ``tmesh`` (tall), reading only
    its shard's bytes and stats.  The launch counts are set to 0 just
    before each mode and read just after.  Returns {mode: (values,
    vectors, n_ops, check mse or None, launches)}; scca's "values" are
    its d, its "vectors" U stacked on V."""
    import torch

    from flashpca_tpu_torch import (PackedOperator, PlinkDataset,
                                    StreamingPackedOperator,
                                    TallPackedOperator,
                                    TallStreamingOperator, check, pca, scca)
    from flashpca_tpu_torch.io.plink import stats_from_moments
    from flashpca_tpu_torch.kernels import packed_matvec as tpk
    from flashpca_tpu_torch.parallel import (sample_sharded_moments,
                                             sharded_operator,
                                             tall_sharded_operator)
    from flashpca_tpu_torch.parallel.dist import sharded_snp_stats

    ds = PlinkDataset.open(root)
    one = mesh is None
    kw = {"device": dev} if one else {}

    def wide(dtype):
        return root if one else sharded_operator(ds, mesh, dtype=dtype)

    def streamed(tall):
        if one:
            return root
        p, nb = ds.n_snps, ds.nbytes_per_snp
        if tall:
            plan = TallPackedOperator.plan_layout(p, nb, nshards=tmesh.size)
            ngood, dsum, _ = sample_sharded_moments(
                ds, tmesh, nbytes_pad=plan["nbytes_pad"])
            mean, sd = stats_from_moments(ngood, dsum, "binom2")
            return TallStreamingOperator(ds, mean, sd, ds.n_samples,
                                         memory_mb=1, mesh=tmesh)
        plan = PackedOperator.plan_layout(p, nb, nshards=mesh.size)
        mean, sd = sharded_snp_stats(ds, mesh, plan["p_pad"])
        return StreamingPackedOperator(ds, mean, sd, ds.n_samples,
                                       memory_mb=1, mesh=mesh)

    f64 = {"dtype": torch.float64} if one else {}
    stream = {"streaming": True, "memory_mb": 1} if one else {}
    runs = {
        "pca32": lambda: pca(wide(torch.float32), MP_K, **kw),
        "pca64": lambda: pca(wide(torch.float64), MP_K, **kw, **f64),
        "stream": lambda: pca(streamed(False), MP_K, **kw, **stream),
        "tall": lambda: pca(root if one else tall_sharded_operator(
            ds, tmesh), MP_K, operator_mode="tall", **kw),
        "tallstream": lambda: pca(streamed(True), MP_K,
                                  operator_mode="tall", **kw, **stream),
    }
    out = {}
    for mode, run in runs.items():
        tpk.reset_launch_counts()
        res = run()
        chk = None
        if mode in ("pca32", "pca64"):
            dt = torch.float64 if mode == "pca64" else torch.float32
            chk = check(wide(dt), res.vectors, res.values, **kw,
                        **(f64 if dt == torch.float64 else {})).mse
        out[mode] = (res.values, res.vectors, res.n_ops, chk,
                     dict(tpk.launch_counts))
    # mid_scca's problem: the same phenotypes and V0 on every process
    Y = mid_phenotypes(ds, MP_SEED)
    tpk.reset_launch_counts()
    sres = scca(wide(torch.float32), Y, SCCA_L1 / np.sqrt(ds.n_snps),
                SCCA_L2, ndim=2, tol=SCCA_MID_TOL, **kw)
    out["scca"] = (sres.d, np.concatenate([sres.U, sres.V]),
                   int(sres.n_iters.sum()), None, dict(tpk.launch_counts))
    return out


def mp_worker(args) -> int:
    """One process of the two-process phase (``--mp-rank``): joins the
    group, runs :func:`mp_modes` on its own shard, times the two
    collectives, and writes its results to ``--mp-out``."""
    import torch

    from flashpca_tpu_torch.parallel import init_distributed, snp_mesh

    rank, world = args.mp_rank, args.mp_world
    nccl = args.mp_backend == "nccl"
    if args.mp_device == "cpu":
        # the phase rehearsed on the CPU (tests/test_torch_dist.py)
        dev = torch.device("cpu")
        sync_dev = lambda: None                            # noqa: E731
        torch.set_num_threads(2)
    else:
        dev = torch.device(f"cuda:{rank if nccl else 0}")
        torch.cuda.set_device(dev)
        sync_dev = torch.cuda.synchronize
    init_distributed(backend=args.mp_backend,
                     init_method=f"tcp://localhost:{args.mp_port}",
                     world_size=world, rank=rank)
    mesh = snp_mesh([str(dev)])
    tmesh = snp_mesh([str(dev)], axis_name="samples")
    assert mesh.size == world and mesh.multiprocess
    out = mp_modes(args.mp_root, dev, mesh, tmesh)
    # the collectives of one product and one solver cycle: the gram's
    # (n4, 16) float32 all-reduce and a (64, 64) float64 broadcast
    n4 = 4 * (-(-8001 // 4))
    t = torch.randn((n4, 16), device=dev)
    h = np.random.default_rng(0).standard_normal((64, 64))
    coll = {}
    for name, fn in (("all_reduce_n4x16_f32", lambda: mesh.all_sum(t)),
                     ("broadcast_64x64_f64", lambda: mesh.agree(h))):
        fn()
        ts = []
        for _ in range(20):
            sync_dev()
            t0 = time.perf_counter()
            fn()
            sync_dev()
            ts.append((time.perf_counter() - t0) * 1e3)
        coll[name] = float(np.median(ts))
    flat = {"collectives": json.dumps(coll)}
    for mode, (vals, vecs, n_ops, chk, launches) in out.items():
        flat.update({f"{mode}.values": vals, f"{mode}.vectors": vecs,
                     f"{mode}.n_ops": n_ops,
                     f"{mode}.check": np.nan if chk is None else chk,
                     f"{mode}.launches": json.dumps(launches)})
    np.savez(os.path.join(args.mp_out, f"rank{rank}.npz"), **flat)
    mesh.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def mp_mesh(dev, workdir, root):
    """Two processes with torch.distributed over the mid-size fileset:
    NCCL across two cards when there are two, else gloo with both ranks
    on the one card; each rank (``python3 chip_smoke.py --mp-rank R``)
    reads only its shard's bytes and runs wide ``pca`` + ``check`` at
    float32 (the kernels on every rank) and float64, the wide and the
    tall path streamed (``memory_mb=1``), the tall path and ``scca``
    (ndim 2); each held to this process's one-process run: the ranks'
    results bit-equal, float32 eigenvalues within MP_F32_BAR relative,
    float64 within MP_F64_BAR, check mse < 1e-8, scca d within
    SCCA_GRID_D_BAR and U, V within SCCA_GRID_UV_BAR.  Each rank has
    MP_TIMEOUT_S: a hung group fails the phase.  Returns a summary."""
    import socket

    import torch

    ncards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if ncards >= MP_NPROC else "gloo"
    say(f"   mp_mesh: {MP_NPROC} processes, backend {backend}, {ncards} "
        "card(s) seen")
    with Phase("mp_mesh: one-process runs on the card"):
        ref = mp_modes(root, dev)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out = os.path.join(workdir, "mp")
    os.makedirs(out)
    script = os.path.abspath(__file__)
    cmd = [sys.executable, script, "--mp-world", str(MP_NPROC),
           "--mp-port", str(port), "--mp-backend", backend, "--mp-root",
           root, "--mp-out", out, "--mp-device", dev.type]
    with Phase(f"mp_mesh: {MP_NPROC} ranks") as ph:
        procs = [subprocess.Popen(cmd + ["--mp-rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(MP_NPROC)]
        logs = []
        try:
            deadline = time.time() + MP_TIMEOUT_S
            for pr in procs:
                logs.append(pr.communicate(
                    timeout=max(1.0, deadline - time.time()))[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"mp_mesh: the ranks did not finish "
                                 f"within {MP_TIMEOUT_S} s")
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        if pr.returncode != 0:
            say(log)
            raise AssertionError(f"mp_mesh: rank {r} exited "
                                 f"{pr.returncode}")
    ranks = [np.load(os.path.join(out, f"rank{r}.npz"))
             for r in range(MP_NPROC)]
    summary = {"backend": backend, "cards": ncards, "ranks_s": ph.seconds,
               "collectives_ms": json.loads(str(ranks[0]["collectives"]))}
    for mode, (vals, vecs, n_ops, chk, launches) in ref.items():
        got = [(d[f"{mode}.values"], d[f"{mode}.vectors"]) for d in ranks]
        for key in ("values", "vectors", "n_ops"):
            if not all(np.array_equal(d[f"{mode}.{key}"],
                                      ranks[0][f"{mode}.{key}"])
                       for d in ranks):
                raise AssertionError(f"mp_mesh {mode}: the ranks' {key} "
                                     "differ")
        rank_launches = [json.loads(str(d[f"{mode}.launches"]))
                         for d in ranks]
        g_vals, g_vecs = got[0]
        if mode == "scca":
            rel = np.abs(g_vals - vals) / np.abs(vals)
            uv = float(np.max(np.abs(g_vecs - vecs)))
            ok = rel.max() <= SCCA_GRID_D_BAR and uv <= SCCA_GRID_UV_BAR
            bar = f"d {SCCA_GRID_D_BAR}, U/V {SCCA_GRID_UV_BAR} (max {uv:.2e})"
            path = SCCA_PATH
        else:
            rel = np.abs(g_vals - vals) / vals
            f64 = mode == "pca64"
            lim = MP_F64_BAR if f64 else MP_F32_BAR
            ok = rel.max() <= lim
            bar = str(lim)
            path = () if f64 else (TALL_PATH if mode.startswith("tall")
                                   else WIDE_PATH)
        g_chk = float(ranks[0][f"{mode}.check"])
        say(f"   {mode}: rel err vs one process {rel.max():.2e} (bar {bar}),"
            f" n_ops {int(ranks[0][f'{mode}.n_ops'])} (one process "
            f"{n_ops}), check mse {g_chk:.3e}; launches per rank "
            + "; ".join(", ".join(f"{nm} {c}" for nm, c in lr.items() if c)
                        or "none" for lr in rank_launches))
        if not ok:
            raise AssertionError(f"mp_mesh {mode}: off the one-process run")
        if not np.isnan(g_chk) and not g_chk < 1e-8:
            raise AssertionError(f"mp_mesh {mode}: check mse {g_chk:.3e}")
        for r, lr in enumerate(rank_launches):
            if path:
                require_launched(lr, path, f"mp_mesh {mode} rank {r}")
            elif any(lr.values()):
                raise AssertionError(f"mp_mesh {mode}: rank {r} launched "
                                     f"kernels at float64 {lr}")
        summary[mode] = {"rel_err": float(rel.max()),
                         "n_ops": int(ranks[0][f"{mode}.n_ops"]),
                         "one_process_n_ops": int(n_ops),
                         "check_mse": g_chk,
                         "launches": rank_launches}
    say(f"   collectives (rank 0, median ms): {summary['collectives_ms']}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=501_760)
    ap.add_argument("--p", type=int, default=100_352)
    ap.add_argument("--k", type=int, default=20)
    # one rank of the two-process phase (mp_mesh starts them)
    ap.add_argument("--mp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-world", type=int, default=MP_NPROC,
                    help=argparse.SUPPRESS)
    for opt in ("--mp-port", "--mp-backend", "--mp-root", "--mp-out",
                "--mp-device"):
        ap.add_argument(opt, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mp_rank is not None and args.mp_device == "cpu":
        return mp_worker(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU only", file=sys.stderr)
        return 1
    if args.mp_rank is not None:
        return mp_worker(args)
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
        with open(os.path.join(build_dir,
                               f"{os.path.splitext(src)[0]}.log")) as fh:
            usages = list(ptxas_usage(fh))
        for fn, usage in usages:
            say(f"   {src} {fn}: {usage}")
        if src in NO_SPILL_SOURCES:
            require_no_spills(src, usages)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass_mix = {}
    for src in SASS_SOURCES:
        lib = os.path.join(build_dir, f"lib{os.path.splitext(src)[0]}.so")
        if not os.path.exists(cuobjdump):
            say(f"   {src}: no cuobjdump beside nvcc; SASS mix not read")
            break
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True).stdout
        for fn, c in sorted(sass_hot_loops(sass).items()):
            if not sass_read(fn):
                continue
            top = ", ".join(f"{o} {n}" for o, n in c.most_common(6))
            if c["HMMA"]:
                kc = int(fn.split("<")[1].split(",")[0])
                ops = split3_ops_per_genotype(c, kc)
                sass_mix[fn] = {"hmma": c["HMMA"], "instructions":
                                sum(c.values()), "ops_per_genotype": ops}
                say(f"   {src} {fn} inner loop: {c['HMMA']} HMMA of "
                    f"{sum(c.values())} instructions; {ops:.3f} CUDA-core "
                    f"instructions a genotype (the function needs "
                    f"{split3_needed_ops_per_genotype(kc):.3f}); {top}")
            else:
                share = c["FFMA"] / sum(c.values())
                sass_mix[fn] = {"ffma": c["FFMA"], "instructions":
                                sum(c.values()), "ffma_share": share}
                say(f"   {src} {fn} inner loop: {c['FFMA']} FFMA of "
                    f"{sum(c.values())} instructions ({share:.1%}); {top}")
    if SPLIT3_SASS not in sass_mix:
        raise AssertionError(f"V3's inner loop ({SPLIT3_SASS}) not read: "
                             "its row reports its CUDA-core instructions a "
                             "genotype")
    require_same_loop(sass_mix, *SAME_LOOP)
    with Phase("kernels against their plain versions"):
        worst = check_kernels(dev)
    torch.cuda.empty_cache()
    with Phase("tall kernels against their plain versions"):
        tall_worst, tall_f64 = check_tall_kernels(dev)
        for name, e in tall_worst.items():
            worst[name] = max(worst.get(name, 0.0), e)
    torch.cuda.empty_cache()
    with Phase("streamed products against their same-order references"):
        streamed_checks = check_streamed(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("tall streamed products against their same-order "
                   "references"):
            tall_streamed_checks = check_tall_streamed(dev, tmp)
        torch.cuda.empty_cache()
        with Phase("mid-size PLINK fileset against float64 eigh, resident "
                   "and streamed"):
            mid = mid_size(dev, tmp)
        torch.cuda.empty_cache()
        with Phase("mp_mesh: two processes on the mid-size fileset"):
            mp = mp_mesh(dev, tmp, os.path.join(tmp, "mid"))
    torch.cuda.empty_cache()
    op, head, head_res = headline(dev, args.n, args.p, args.k)
    torch.cuda.empty_cache()
    # the same bytes on two shards of the card (row views, no copy)
    shard_rows, sharded = sharded_headline(dev, op, head_res, head, worst,
                                           args.k)
    torch.cuda.empty_cache()
    # project() and ucca() on the headline's operator, one pass each
    twins, one_pass = project_ucca(op, head_res)
    torch.cuda.empty_cache()
    # scca() and scca_grid() on the headline's operator (B1 and B2)
    scca_twins, scca_out = scca_headline(op)
    torch.cuda.empty_cache()
    with Phase("kernel times at the headline shapes"):
        # B1/B2 at the solver panel and the polish sweeps' width, B3/B4
        # at the polish / check width
        kernels = time_kernels(
            op, [("crossprod", 16), ("matvec", 16), ("crossprod_ff", 24),
                 ("matvec_ff", 24), ("crossprod", 24), ("matvec", 24)],
            head["launches"], worst, slices=32)
        b1_turns = time_b1(op, (16,))
        b2_turns = time_b2(op, (16, 24))
        b3_turns = time_b3(op, (24,))
        b4_turns = time_b4(op, (24,))
    kernels = with_first_designs(
        kernels, {"crossprod": ("crossprod_v1", b1_turns),
                  "matvec": ("matvec_v1", b2_turns),
                  "crossprod_ff": ("crossprod_ff_v1", b3_turns),
                  "matvec_ff": ("matvec_ff_v1", b4_turns)},
        head["launches"], worst)
    b1_library_ms = next(r["library_ms"] for r in kernels
                         if r["name"] == "crossprod" and r["k"] == 16)
    # B2 at project's kc 24 and B1 at ucca's kc 8
    with Phase("kernel times: project's B2 and ucca's B1"):
        for what, name, kc in (("project", "matvec", 24),
                               ("ucca", "crossprod", 8)):
            for row in time_kernels(op, [(name, kc)],
                                    {name: one_pass[what]["launches"]},
                                    None, slices=32):
                kernels.append(dict(row, path=what))
    # scca()'s B1 and B2 on its one column and B2 at kc 8 on its Px; the
    # grid's at kc 16
    with Phase("kernel times: scca's B1 and B2 on one column, its Px"):
        kernels += scca_rows(
            op, scca_out["launches"], scca_out["grid"]["launches"],
            [r for r in kernels if r.get("design") != "first"
             and "path" not in r], "", slices=32)
    # the same bytes streamed from the host: the card cannot hold them
    # twice, so the resident operator goes first
    with Phase("headline bytes to the host"):
        host = op.packed.cpu().numpy()
        center, scale, sumsq = op.center, op.scale, op.snp_sumsq
    del op
    torch.cuda.empty_cache()
    stream_rows, stream = streamed_headline(
        dev, host, center, scale, sumsq, head_res, head["launch_ms"],
        head["seed_witness"], twins, scca_twins=scca_twins)
    del head_res, twins, scca_twins
    torch.cuda.empty_cache()
    # cv_scca and split_scca on the headline's first SNPs, all samples
    cv_rows, cv_split = headline_cv_split(dev, host, center, scale, args.n)
    del host
    torch.cuda.empty_cache()
    dense = dense_headline(dev, smi)
    torch.cuda.empty_cache()
    sweep_rows, sweep = kernel_sweep(
        dev, args.p, args.n, worst, b1_library_ms, head["launches"],
        sass_mix[SPLIT3_SASS]["ops_per_genotype"])
    torch.cuda.empty_cache()
    top, tall, tall_res = tall_headline(dev, TALL_N, TALL_P, args.k)
    torch.cuda.empty_cache()
    # the same bytes on two byte-column shards of the card
    tall_shard_rows, sharded_tall_out = sharded_tall(dev, top, tall_res,
                                                     tall, worst, args.k)
    torch.cuda.empty_cache()
    with Phase("kernel times at the tall shapes"):
        # B5 at the polish widths (nev 28 -> kc 32, and kc 24); B1-B3 at
        # their tall widths (B1/B2 the solver panel, B1/B2/B3 the polish
        # at kc 24 and 32); B4 at the wide operator's check width on the
        # tall bytes
        tall_rows = time_kernels(
            top, [("matvec_ff_novl", 32), ("matvec_ff_novl", 24),
                  ("crossprod", 16), ("matvec", 16), ("crossprod", 32),
                  ("crossprod_ff", 32), ("crossprod", 24), ("matvec", 24),
                  ("matvec", 32), ("crossprod_ff", 24), ("matvec_ff", 24)],
            tall["launches"], worst, slices=64)
        novl = time_novl(top, (32, 24))
        b1_tall_turns = time_b1(top, (16, 32))
        b2_tall_turns = time_b2(top, (16, 24, 32))
        b3_tall_turns = time_b3(top, (24, 32))
        b4_tall_turns = time_b4(top, (24,))
    # the first designs beside B5 at kc 32/24, B1 at kc 16/32, B2 at kc
    # 16/24/32, B3 at kc 24/32, B4 at kc 24
    kernels.extend(with_first_designs(
        tall_rows, {"matvec_ff_novl": ("matvec_ff_novl_v1", novl),
                    "crossprod": ("crossprod_v1", b1_tall_turns),
                    "matvec": ("matvec_v1", b2_tall_turns),
                    "crossprod_ff": ("crossprod_ff_v1", b3_tall_turns),
                    "matvec_ff": ("matvec_ff_v1", b4_tall_turns)},
        tall["launches"], worst))
    # the same tall bytes streamed from the host under the same bound
    with Phase("tall headline bytes to the host"):
        host = top.packed.cpu().numpy()
        center, scale, sumsq = top.center, top.scale, top.snp_sumsq
    del top
    torch.cuda.empty_cache()
    tall_stream_rows, tall_stream = streamed_tall_headline(
        dev, host, center, scale, sumsq, tall_res, tall["check_mse"],
        tall["launch_ms"])
    del host, tall_res
    kernels.extend(shard_rows)
    kernels.extend(tall_shard_rows)
    kernels.extend(sweep_rows)
    kernels.extend(stream_rows)
    kernels.extend(cv_rows)
    kernels.extend(tall_stream_rows)
    say(json.dumps({"summary": {
        "card": smi, "n": args.n, "p": args.p, "k": args.k,
        "build_s": build_s, "sass_mix": sass_mix, "mid": mid,
        "streaming": {**stream, "same_order": streamed_checks,
                      "tall": {**tall_stream,
                               "same_order": tall_streamed_checks}},
        **{key: val for key, val in head.items()},
        "one_pass": one_pass, "dense": dense, "scca": scca_out,
        "cv_split": cv_split, "sharded": sharded,
        "sharded_tall": sharded_tall_out, "mp_mesh": mp,
        "gram_tall_ff_max_abs_err": worst["gram_tall_ff"],
        "tall_kernels_f64_rel": tall_f64,
        "b1_turns_ms": b1_turns, "b2_turns_ms": b2_turns,
        "b3_turns_ms": b3_turns, "b4_turns_ms": b4_turns,
        "tall": {"n": TALL_N, "p": TALL_P, **tall,
                 "kernels": tall_rows, "b5_turns_ms": novl,
                 "b1_turns_ms": b1_tall_turns,
                 "b2_turns_ms": b2_tall_turns,
                 "b3_turns_ms": b3_tall_turns,
                 "b4_turns_ms": b4_tall_turns},
        "sweep": sweep,
        "total_s": time.time() - t_start}}))
    say(json.dumps({"kernels": kernels, "streaming": {
        "launches": stream["launches"], "launch_ms": stream["launch_ms"],
        "block_snps": stream["block_snps"], "n_blocks": stream["n_blocks"],
        "memory_mb": stream["memory_mb"], "tall": {
            key: tall_stream[key] for key in (
                "launches", "launch_ms", "block_bytes", "n_blocks",
                "memory_mb")}}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
