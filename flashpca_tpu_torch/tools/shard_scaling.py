"""The wide headline sharded over several cards in one process, and the
two-process phase across cards.

    python -m flashpca_tpu_torch.tools.shard_scaling [--shards 1,2,4]
        [--mp] [--out FILE]

Run from the root of a checkout on a machine with as many cards as the
largest shard count.  It takes the wide headline's bytes as
``chip_smoke.py`` generates them on the first card (501,760 x 100,352,
seed 7) and, for each count S, runs ``pca(op, 20)`` (float32,
``polish="contract"``) and ``check()`` on a one-process mesh over the
first S cards (``cuda:0`` holds its shard as a row view, the others a
copy of theirs), printing the walls, ``n_ops``, the gate's and the
check's mse and each run's largest eigenvalue difference from the first
count's.  With ``--mp`` it then runs ``chip_smoke.mp_mesh`` on the
mid-size fileset: two processes, NCCL when two cards are visible, with
its collectives timed.

Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def scaling(devices_for, counts, n, p, k=20, seed=7):
    """pca + check of ``card_data(n, p, seed)`` on a mesh of
    ``devices_for(S)`` for each S in ``counts``; one row each."""
    import chip_smoke as cs

    from ..models.check import check
    from ..models.pca import pca
    from ..ops.operator import PackedOperator
    from ..parallel import snp_mesh

    first = torch.device(devices_for(1)[0])
    packed, mean, sd, sumsq = cs.card_data(first, n, p, seed)
    rows, ref = [], None
    for S in counts:
        op = PackedOperator(packed, mean, sd, n, snp_sumsq=sumsq,
                            mesh=snp_mesh(devices_for(S)))
        cs.sync()
        t0 = time.perf_counter()
        res = pca(op, k)
        cs.sync()
        t1 = time.perf_counter()
        chk = check(op, res.vectors, res.values)
        cs.sync()
        t2 = time.perf_counter()
        ref = res.values if ref is None else ref
        rows.append({"shards": S, "pca_s": t1 - t0, "check_s": t2 - t1,
                     "n_ops": res.n_ops, "gate_mse": res.gate_mse,
                     "check_mse": chk.mse,
                     "eig_rel_err": float(np.max(np.abs(res.values - ref)
                                                 / ref))})
        print(json.dumps(rows[-1]), flush=True)
        del op
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", default="1,2,4",
                    help="comma-separated card counts")
    ap.add_argument("--mp", action="store_true",
                    help="also run chip_smoke.mp_mesh across two cards")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_scaling: no CUDA device; this tool times the cards",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    from ..kernels import _build

    ncards = torch.cuda.device_count()
    counts = [c for c in (int(x) for x in args.shards.split(","))
              if c <= ncards]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    out = {"card": card, "cards": ncards, "n": 501_760, "p": 100_352,
           "rows": scaling(lambda S: [f"cuda:{i}" for i in range(S)],
                           counts, 501_760, 100_352)}
    torch.cuda.empty_cache()
    if args.mp:
        with tempfile.TemporaryDirectory() as tmp:
            out["mp_mesh"] = cs.mp_mesh(torch.device("cuda:0"), tmp,
                                        cs.write_mid_fileset(tmp))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
