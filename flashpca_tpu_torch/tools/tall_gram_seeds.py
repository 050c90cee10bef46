"""The tall two-float gram of the card test
``tests/test_torch_cuda.py::test_tall_kernels_match_plain[333-4096-28]``
over a range of input seeds on one GPU.

    python -m flashpca_tpu_torch.tools.tall_gram_seeds [--seeds A:B]
        [--out FILE]

The packed bytes are the test's (:func:`operands`, seed 11, as the
test's ``_operands`` draws them); the panel v and the hi and lo tables
come from a ``torch.Generator`` seeded with each seed (:func:`draws`,
which the test calls at one fixed seed).  For each seed the gram runs
on the card (B5, mask, B3, B1) and its plain version on the CPU, and
the tool prints:

* hi: the worst |z_hi - plain z_hi| / (2e-3 + 2e-4 |plain z_hi|), the
  gram's hi halves at the test's hi-half bar (at most 1 passes).  The
  share of the sum that each side leaves in the lo half follows its own
  summation order in B5, so the test does not hold the gram's hi
  halves to this bar;
* pair: the relative error of the pairs' float64 sums (the test's bar
  5e-6);
* b3: the hi-half ratio for B3 alone, on the card's own masked y_hi,
  against B3's plain version on that input: the test's hi-half check
  of the gram's second stage;
* at the worst hi entry, the card's and the plain version's pairs and
  hi halves against the float64 gram of the same tables.

Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..kernels import packed_matvec as tpk
from ..ops.compensated import decode_lut
from ..ops.genotypes import valid_mask_permuted

HI_BAR = (2e-4, 2e-3)        # the card test's (rtol, atol) on hi halves
P, N, K = 333, 4096, 28      # the card test's case


def operands(n, p, seed=11):
    """The card test's packed bytes, means and inverse sds (CPU)."""
    g = torch.Generator().manual_seed(seed)
    nb = (n + 3) // 4
    packed = torch.randint(0, 256, (p, nb), generator=g, dtype=torch.uint8)
    mean = 0.1 + 1.8 * torch.rand(p, generator=g)
    invsd = 0.5 + 1.5 * torch.rand(p, generator=g)
    invsd[-5:] = 0.0
    return packed, mean, invsd


def draws(p, k, seed):
    """The panel v (p, k) and the hi and lo code tables (p, 4) of one
    seed, float32 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((p, k), generator=g)
    lh = torch.randn((p, 4), generator=g)
    ll = torch.randn((p, 4), generator=g) * 1e-8
    return v, lh, ll


def hi_ratio(got, want):
    """(worst |got - want| / (atol + rtol |want|), its flat index)."""
    rtol, atol = HI_BAR
    w = want.double()
    r = (got.double() - w).abs() / (atol + rtol * w.abs())
    return float(r.max()), int(r.argmax())


def case(dev, p, n, k, seed):
    """The readings of one seed (see the module's note)."""
    packed, mean, invsd = operands(n, p)
    v, lh, ll = draws(p, k, seed)
    nb = packed.shape[1]
    valid = valid_mask_permuted(n, nb, torch.float32)
    cpu = (packed, lh, ll, mean, invsd, v, valid)
    zh, zl = (t.cpu() for t in tpk.gram_tall_ff_p(
        *(t.to(dev) for t in cpu)))
    ph, pl = tpk.gram_tall_ff_p(*cpu)
    hi, at = hi_ratio(zh, ph)
    a = zh.double() + zl.double()
    b = ph.double() + pl.double()
    pair = float((a - b).norm() / b.norm())
    # B3 alone on the card's own masked y_hi
    lut6 = tpk.lut_rows(lh, ll)
    yh, _ = tpk.matvec_ff_novl_p(packed.to(dev), lut6.to(dev), v.to(dev))
    ym = yh * valid.to(dev)[:, None]
    bh, _ = tpk.crossprod_ff_p(packed.to(dev), lut6.to(dev), ym)
    qh, _ = tpk.crossprod_ff_plain(packed, lut6, ym.cpu())
    b3, _ = hi_ratio(bh.cpu(), qh)
    # the float64 gram of the same tables (code 1 decodes to 0)
    lut = lh.double() + ll.double()
    lut[:, 1] = 0.0
    W = decode_lut(packed, lut, torch.float64)
    z64 = W @ ((W.T @ v.double()) * valid.double()[:, None])
    ref = float(z64.flatten()[at])
    return {"seed": seed, "hi_ratio": hi, "pair_rel": pair, "b3_ratio": b3,
            "entry": at, "z64": ref,
            "card_pair_err": abs(float(a.flatten()[at]) - ref),
            "plain_pair_err": abs(float(b.flatten()[at]) - ref),
            "card_hi_err": abs(float(zh.flatten()[at]) - ref),
            "plain_hi_err": abs(float(ph.flatten()[at]) - ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0:32", help="A:B, seeds A..B-1")
    ap.add_argument("--out", help="also write the readings to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tall_gram_seeds: no CUDA device; the gram runs on a GPU "
              "only", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lo, hi = (int(s) for s in args.seeds.split(":"))
    rows = []
    for seed in range(lo, hi):
        r = case(torch.device("cuda"), P, N, K, seed)
        rows.append(r)
        print(f"   seed {seed:3d}: hi {r['hi_ratio']:.3f} of its bar, pair "
              f"{r['pair_rel']:.2e}, b3 {r['b3_ratio']:.3f}; at entry "
              f"{r['entry']} (float64 {r['z64']:.4e}): pair err card "
              f"{r['card_pair_err']:.2e} plain {r['plain_pair_err']:.2e}, "
              f"hi err card {r['card_hi_err']:.2e} plain "
              f"{r['plain_hi_err']:.2e}", flush=True)
    miss = [r["seed"] for r in rows if r["hi_ratio"] > 1.0]
    worst = {key: max(r[key] for r in rows)
             for key in ("hi_ratio", "pair_rel", "b3_ratio")}
    print(f"   p={P} n={N} k={K}: hi bar missed at seeds "
          f"{miss} of {hi - lo}; worst hi {worst['hi_ratio']:.3f}, worst "
          f"pair {worst['pair_rel']:.2e}, worst b3 {worst['b3_ratio']:.3f}",
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "p": P, "n": N, "k": K,
                       "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
