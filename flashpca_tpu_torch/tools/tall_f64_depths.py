"""float64 on the card at the tall headline's shape, by SNP depth.

    python -m flashpca_tpu_torch.tools.tall_f64_depths [--depths 2048,4096]
        [--k 20] [--out FILE]

Run from the root of a checkout: it takes the tall headline's bytes as
``chip_smoke.py`` generates them on the card (1,003,520 samples, seed
8) and, for each depth d, runs ``chip_smoke.tall_float64``:
``pca(TallPackedOperator(..., dtype=float64), k)`` on the first d SNPs
through the functional core, held to the float64 eigendecomposition of
their gram X_d^T X_d / d (``chip_smoke.f64_reference``, formed on the
card).  It prints each depth's passes (``n_ops``), wall and largest
eigenvalue error, the numbers behind ``chip_smoke.F64_PASSES``: the
passes grow with the depth, and the smoke cuts the depth so that
F64_PASSES float64 gram passes fit its F64_SOLVE_S budget.

Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", default="2048,4096",
                    help="comma-separated SNP depths")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tall_f64_depths: no CUDA device; this tool times the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    from ..ops.operator import TallPackedOperator

    depths = sorted(int(d) for d in args.depths.split(","))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    packed, mean, sd, sumsq = cs.card_data(dev, cs.TALL_N, cs.TALL_P, 8)
    d = depths[-1]
    top = TallPackedOperator(packed[:d].clone(), mean[:d], sd[:d], cs.TALL_N,
                             device=dev, snp_sumsq=sumsq[:d])
    del packed
    torch.cuda.empty_cache()
    rows = []
    for d in depths:
        ref, cut = cs.f64_reference(top, args.k + 8, depth=d)
        rows.append(cs.tall_float64(top, args.k, d, cut or ref))
        torch.cuda.empty_cache()
    out = {"card": card, "n": cs.TALL_N, "k": args.k, "rows": rows}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
