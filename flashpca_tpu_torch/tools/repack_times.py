"""Host seconds of the sample repack and the per-SNP moments.

    PYTHONPATH=CHECKOUT python flashpca_tpu_torch/tools/repack_times.py
        [--snps 1024] [--samples 501760] [--train 0.8] [--threads 1,8]
        [--out FILE]

Times the ``flashpca_tpu_torch`` that Python imports, so a run with an
older checkout first on ``PYTHONPATH`` gives that checkout's seconds
beside this one's (the script imports the package by its name, so run
it as a file, not with ``-m``).  It writes random .bed bytes for
``--snps`` SNPs of ``--samples`` samples (seed 0) into a temporary
directory, draws a ``--train`` share of the samples (``uniform <
train``, seed 1), and times, each once, on this machine's host:

* ``train_s``: ``subset_samples`` of the train samples;
* ``two_reads_s``: ``subset_samples`` of the train samples, then of the
  rest: two reads of the source;
* ``one_read_s``: ``subset_samples_many`` of both in one read (null
  where the package has no such function);
* ``moments_s``: ``snp_moments`` of the train fileset without the
  native library.

Where the package has a host thread count (``io.plink._THREADS``) each
is timed at every count of ``--threads``; the bytes written are held
equal across counts and to ``pack_codes(unpack_codes(...)[:, idx])``,
and the moments across counts.  Prints one JSON line; needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def write_fileset(root, packed, n):
    """A .bed of ``packed`` and minimal .bim/.fam beside it."""
    with open(root + ".bed", "wb") as fh:
        fh.write(b"\x6c\x1b\x01")
        fh.write(packed.tobytes())
    with open(root + ".bim", "w") as fh:
        fh.writelines(f"1\tsnp{j}\t0\t{j + 1}\tA\tC\n"
                      for j in range(packed.shape[0]))
    with open(root + ".fam", "w") as fh:
        fh.writelines(f"s{i}\ts{i}\t0\t0\t0\t-9\n" for i in range(n))


def run_once(plink, ds, idx, rest, workdir, tag):
    """The four timings at the package's current thread count, and the
    bytes and moments they produced."""
    tr, te = (os.path.join(workdir, f"{tag}_{s}") for s in ("tr", "te"))
    t_train, _ = timed(lambda: plink.subset_samples(ds, idx, tr))
    t_test, _ = timed(lambda: plink.subset_samples(ds, rest, te))
    t_one = None
    if hasattr(plink, "subset_samples_many"):
        t_one, _ = timed(lambda: plink.subset_samples_many(
            ds, [(idx, tr + "1"), (rest, te + "1")]))
        for a, b in ((tr, tr + "1"), (te, te + "1")):
            with open(a + ".bed", "rb") as fa, open(b + ".bed", "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError("one read and two reads differ")
    t_mom, mom = timed(lambda: plink.PlinkDataset.open(tr).snp_moments())
    with open(tr + ".bed", "rb") as fh:
        train_bytes = fh.read()
    return ({"train_s": t_train, "two_reads_s": t_train + t_test,
             "one_read_s": t_one, "moments_s": t_mom}, train_bytes, mom)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=501_760)
    ap.add_argument("--train", type=float, default=0.8)
    ap.add_argument("--threads", default="1,8",
                    help="comma-separated host thread counts")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    from flashpca_tpu_torch.io import cbed, plink

    saved = (cbed.available, cbed.moments_available,
             getattr(plink, "_THREADS", None))
    cbed.available = cbed.moments_available = lambda: False
    try:
        out = measure(plink, args)
    finally:
        cbed.available, cbed.moments_available = saved[:2]
        if saved[2] is not None:
            plink._THREADS = saved[2]
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


def measure(plink, args):
    n, m = args.samples, args.snps
    packed = np.random.default_rng(0).integers(
        0, 256, size=(m, plink.bytes_per_snp(n)), dtype=np.uint8)
    train = np.random.default_rng(1).uniform(size=n) < args.train
    idx, rest = np.flatnonzero(train), np.flatnonzero(~train)
    counts = ([int(t) for t in args.threads.split(",")]
              if hasattr(plink, "_THREADS") else [None])
    out = {"package": os.path.dirname(plink.__file__), "snps": m,
           "samples": n, "kept": int(idx.size), "cpus": os.cpu_count(),
           "numpy": np.__version__, "by_threads": {}}
    with tempfile.TemporaryDirectory() as workdir:
        root = os.path.join(workdir, "src")
        write_fileset(root, packed, n)
        ds = plink.PlinkDataset.open(root)
        want = plink.pack_codes(plink.unpack_codes(packed, n)[:, idx],
                                idx.size).tobytes()
        first_mom = None
        for t in counts:
            if t is not None:
                plink._THREADS = t
            times, got, mom = run_once(plink, ds, idx, rest, workdir,
                                       f"t{t}")
            if got[3:] != want:
                raise AssertionError(f"the repack at {t} threads differs")
            first_mom = mom if first_mom is None else first_mom
            if not all(np.array_equal(a, b) for a, b in zip(mom, first_mom)):
                raise AssertionError(f"the moments at {t} threads differ")
            out["by_threads"][str(t)] = times
    out["source_bytes"] = int(packed.size)
    return out


if __name__ == "__main__":
    sys.exit(main())
