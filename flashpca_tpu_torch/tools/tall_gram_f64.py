"""The tall two-float gram against a float64 gram at the card test's
cases (``tests/test_torch_cuda.py::test_tall_kernels_match_plain``) on
one GPU.

    python -m flashpca_tpu_torch.tools.tall_gram_f64 [--out FILE]

Each case takes the test's packed bytes, means and inverse sds
(:func:`tall_gram_seeds.operands`), its seeded panel v
(:func:`tall_gram_seeds.draws`, seed 12) and the exact two-float tables
of those means and sds, so that B1's pass over the lo half decodes the
W that the tables hold.  It prints the gram's error against the float64
gram of the tables two ways: relative in norm over all entries, which
the card test and ``chip_smoke.py`` hold to GRAM_F64_BAR (1.5e-7), and
entry by entry, in units of its column's largest |z|.

Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels import packed_matvec as tpk
from ..ops.compensated import code_value_luts, decode_lut
from ..ops.genotypes import valid_mask_permuted
from .tall_gram_seeds import draws, operands

# the card test's (p, n) and k
CASES = tuple((p, n, k) for p, n in ((333, 1001), (333, 4096), (133, 771))
              for k in (3, 5, 16, 24, 28))


def readings(dev, p, n, k):
    """The gram of one case on ``dev`` against float64."""
    packed, mean, invsd = (t.to(dev) for t in operands(n, p))
    v = draws(p, k, 12)[0].to(dev)
    valid = valid_mask_permuted(n, packed.shape[1], torch.float32, dev)
    i64 = invsd.double().cpu().numpy()
    sd64 = np.divide(1.0, i64, out=np.zeros_like(i64), where=i64 > 0)
    lh, ll = (torch.as_tensor(t, device=dev) for t in code_value_luts(
        mean.double().cpu().numpy(), sd64))
    zh, zl = tpk.gram_tall_ff_p(packed, lh, ll, mean, invsd, v, valid)
    W = decode_lut(packed, lh.double() + ll.double(), torch.float64)
    z64 = W @ ((W.T @ v.double()) * valid.double()[:, None])
    d = zh.double() + zl.double() - z64
    return {"p": p, "n": n, "k": k,
            "norm_rel": float(d.norm() / z64.norm()),
            "entry_of_column_max": float((d.abs() / z64.abs().amax(0))
                                         .max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the readings to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tall_gram_f64: no CUDA device; the gram runs on a GPU only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for p, n, k in CASES:
        r = readings(torch.device("cuda"), p, n, k)
        rows.append(r)
        print(f"   p={p} n={n} k={k}: relative in norm {r['norm_rel']:.3e}, "
              f"entry by entry {r['entry_of_column_max']:.3e} of its "
              "column's largest", flush=True)
    for key in ("norm_rel", "entry_of_column_max"):
        print(f"   {key}: {min(r[key] for r in rows):.3e} to "
              f"{max(r[key] for r in rows):.3e}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
