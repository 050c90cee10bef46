"""Command-line front end, flag-compatible with the reference binary.

Mirrors flashpca.cpp's option table (flashpca.cpp:40-92), checks
(:136-228), defaults (ndim=10, standx=binom2, div=p, tol=1e-6,
maxiter=500, seed=1, precision=7, suffix=.txt) and output files and
formats (:755-878) for the two modes this package ports: PCA (the
default) and ``--check``.  ``--scca``, ``--ucca``, ``--project`` and
``--batch`` exit with an error naming the ROADMAP item that ports them.
``--device`` (default ``cuda``) selects the card or the CPU path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import __version__
from .io.plink import PlinkDataset
from .io.text import read_text, save_text, TXT_SEP
from .models.check import check as run_check
from .models.pca import pca as run_pca
from .utils.logging import log, set_show_timestamp, timestamp

# modes of the reference CLI that are not ported yet -> ROADMAP item
NOT_PORTED = {
    "scca": "A14 'SCCA family'",
    "ucca": "A13 'ucca()'",
    "project": "A11 'project()'",
    "batch": "A12 'Dense and matrix inputs'",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flashpca-tpu-torch", add_help=False,
        description="PCA of PLINK genotype data on an NVIDIA GPU "
                    "(flag-compatible with flashpca 2.x)")
    p.add_argument("--help", action="help")
    p.add_argument("--cca", action="store_true",
                   help="canonical correlation analysis [DISABLED, "
                        "matches the reference]")
    p.add_argument("--scca", action="store_true",
                   help="sparse CCA [not ported yet]")
    p.add_argument("--ucca", action="store_true",
                   help="per-SNP CCA [not ported yet]")
    p.add_argument("--project", "-p", action="store_true",
                   help="project new samples [not ported yet]")
    p.add_argument("--check", "-c", action="store_true",
                   help="check eigenvalues/eigenvectors")
    p.add_argument("--batch", action="store_true",
                   help="load all genotypes into RAM [not ported yet]")
    p.add_argument("--memory", "-m", type=int, default=None,
                   help="size of block, in MB")
    p.add_argument("--blocksize", "-b", type=int, default=None,
                   help="size of block, in number of SNPs")
    p.add_argument("--numthreads", "-n", type=int, default=None,
                   help="OpenMP threads for the native host IO kernels")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--bed"), p.add_argument("--bim"), p.add_argument("--fam")
    p.add_argument("--bfile")
    p.add_argument("--ndim", "-d", type=int, default=10)
    p.add_argument("--standx", "-s", default="binom2",
                   choices=["binom", "binom2"])
    p.add_argument("--div", default="p", choices=["p", "n1", "none"])
    p.add_argument("--outpc"), p.add_argument("--outvec")
    p.add_argument("--outload"), p.add_argument("--outval")
    p.add_argument("--outpve"), p.add_argument("--outmeansd")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--suffix", "-f", default=".txt")
    p.add_argument("--precision", type=int, default=7)
    p.add_argument("--notime", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="compute dtype (default: float32 on cuda, "
                        "float64 on cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or the CPU path")
    p.add_argument("--opmode", default="auto",
                   choices=["auto", "wide", "tall"],
                   help="decompose X X^T (wide), X^T X (tall, for "
                        "N >> p), or pick automatically")
    p.add_argument("--polish", default="contract",
                   choices=["contract", "fast"],
                   help="float32 accuracy/speed knob: 'contract' "
                        "(default) meets the reference's --check "
                        "mse < 1e-8 via the compensated polish; 'fast' "
                        "stops at the plain float32 floor in about half "
                        "the passes")
    return p


def _die(msg: str) -> int:
    print(f"Error: {msg}", file=sys.stderr)
    print("Use --help to get more help", file=sys.stderr)
    return 1


def _block_size_from_memory(memory_mb, n, p, ndim, do_loadings, verbose):
    """The reference's memory-budget -> block-size formula
    (flashpca.cpp:636-684), kept for CLI compatibility."""
    mem = memory_mb * 1048576
    mem_req = (
        2 * p * 8 * 2
        + 3 * p * 8
        + n * ndim * 8
        + (p * ndim * 8 if do_loadings else 0)
        + 2 * n
        + 2 * (n + p) * ndim * 8
        + 2 * 1024 * 1024 + n * 8
    )
    remain = mem - mem_req
    if verbose:
        print(timestamp() + f"mem: {mem}")
        print(timestamp() + f"mem_req: {mem_req}")
        print(timestamp() + f"mem remaining: {remain}")
    if remain <= 0:
        raise ValueError(
            "The memory specified using --memory is not sufficient, try "
            f"increasing it to at least {(mem_req + n * 8) // 1048576} MB")
    bs = int(remain // (n * 8))
    if bs < 1:
        raise ValueError(
            "The memory specified using --memory is not sufficient, "
            "try increasing it")
    return bs


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    set_show_timestamp(not args.notime)
    if args.version:
        print(f"flashpca-tpu-torch {__version__}")
        return 0

    print(timestamp() + "arguments: flashpca-tpu-torch "
          + " ".join(argv if argv is not None else sys.argv[1:]))

    modes = [m for m in ("cca", "scca", "ucca", "project", "check")
             if getattr(args, m)]
    if len(modes) > 1:
        return _die(f"conflicting modes requested: --{modes[0]}, "
                    f"--{modes[1]}")
    mode = modes[0] if modes else "pca"
    if mode == "cca":
        print("Error: CCA is currently disabled", file=sys.stderr)
        return 1
    for flag in (mode, "batch" if args.batch else None):
        if flag in NOT_PORTED:
            return _die(f"--{flag} is not ported to the PyTorch package "
                        f"yet (ROADMAP {NOT_PORTED[flag]})")
    if unknown:
        return _die("unrecognized arguments: " + " ".join(unknown))
    if args.numthreads is not None and args.numthreads > 0:
        from .io.cbed import set_num_threads

        set_num_threads(args.numthreads)
    if args.memory is not None and args.blocksize is not None:
        return _die("cannot specify both --memory and --blocksize at the "
                    "same time")
    if args.memory is not None and args.memory < 1:
        return _die("memory (MB) must be >=1")
    if args.blocksize is not None and args.blocksize < 1:
        return _die("blocksize must be >=1")
    if args.ndim < 1:
        return _die("--ndim can't be less than 1")
    if args.maxiter <= 0:
        return _die("--maxiter can't be less than 1")
    if args.tol <= 0:
        return _die("--tol can't be zero or negative")
    if args.precision is not None and args.precision <= 1:
        return _die("output --precision too low")
    if args.opmode != "auto" and mode != "pca":
        return _die("--opmode applies to PCA mode only (the other modes "
                    "run the wide operator)")
    if args.polish != "contract" and mode != "pca":
        return _die("--polish applies to PCA mode only")

    if args.bfile:
        bed, bim, fam = (args.bfile + ext for ext in (".bed", ".bim", ".fam"))
    elif args.bed and args.bim and args.fam:
        bed, bim, fam = args.bed, args.bim, args.fam
    else:
        return _die("you must specify either --bfile or --bed / --fam / "
                    "--bim")

    suffix = args.suffix
    out = {
        "pc": args.outpc or f"pcs{suffix}",
        "vec": args.outvec or f"eigenvectors{suffix}",
        "val": args.outval or f"eigenvalues{suffix}",
        "pve": args.outpve or f"pve{suffix}",
        "meansd": args.outmeansd or f"meansd{suffix}",
        "load": args.outload,
    }
    prec = args.precision

    try:
        ds = PlinkDataset.open(bed, bim, fam)
        log(f"Detected BED file: {bed} with N={ds.n_samples} samples, "
            f"{ds.n_snps} SNPs", verbose=args.verbose)

        # the reference validates ndim before the mode switch
        max_dim = int((min(ds.n_samples, ds.n_snps) - 1) / 2.0)
        if args.ndim > max_dim:
            return _die(f"You asked for {args.ndim} dimensions, but only "
                        f"{max_dim} allowed")

        block_size = args.blocksize
        if block_size is None and args.memory is not None:
            try:
                block_size = _block_size_from_memory(
                    args.memory, ds.n_samples, ds.n_snps, args.ndim,
                    bool(args.outload), args.verbose)
            except ValueError as e:
                return _die(str(e))
        if block_size is not None:
            block_size = min(block_size, ds.n_snps)
            print(timestamp() + f"blocksize: {block_size}")

        def fam_rownames():
            return [f + TXT_SEP + i for f, i in zip(ds.fam_ids,
                                                    ds.indiv_ids)]

        def snp_rownames():
            return [s + TXT_SEP + a for s, a in zip(ds.snp_ids,
                                                    ds.ref_alleles)]

        meansd_out = None
        if mode == "pca":
            print(timestamp() + "PCA begin")
            res = run_pca(
                ds, args.ndim, stand=args.standx, divisor=args.div,
                maxiter=args.maxiter, tol=args.tol, seed=args.seed,
                block_size=block_size, do_loadings=bool(args.outload),
                dtype=args.dtype, device=args.device, verbose=args.verbose,
                operator_mode=args.opmode, polish=args.polish)
            print(timestamp() + "PCA done")
            save_text(res.values.reshape(-1, 1), out["val"], precision=prec)
            ucol = ["FID" + TXT_SEP + "IID"] + [
                f"U{i+1}" for i in range(res.vectors.shape[1])]
            save_text(res.vectors, out["vec"], colnames=ucol,
                      rownames=fam_rownames(), precision=prec)
            pccol = ["FID" + TXT_SEP + "IID"] + [
                f"PC{i+1}" for i in range(res.projection.shape[1])]
            save_text(res.projection, out["pc"], colnames=pccol,
                      rownames=fam_rownames(), precision=prec)
            save_text(res.pve.reshape(-1, 1), out["pve"], precision=prec)
            if args.outload:
                vcol = ["SNP" + TXT_SEP + "RefAllele"] + [
                    f"V{i+1}" for i in range(res.loadings.shape[1])]
                save_text(res.loadings, out["load"], colnames=vcol,
                          rownames=snp_rownames(), precision=prec)
            meansd_out = np.column_stack([res.center, res.scale])
        else:  # check
            eval_ = read_text(out["val"], firstcol=1, skip=0)[:, 0]
            evec = read_text(out["vec"], firstcol=3, skip=1)
            res = run_check(ds, evec, eval_, stand=args.standx,
                            divisor=args.div, block_size=block_size,
                            dtype=args.dtype, device=args.device,
                            memory_mb=args.memory)
            for j in range(len(res.err)):
                print(timestamp() + f"eval({j+1}): {eval_[j]}, "
                      f"sum squared error: {res.err[j]}")
            print(timestamp() + f"Mean squared error: {res.mse}, "
                  f"Root mean squared error: {res.rmse} "
                  f"(n={ds.n_samples})")

        if args.outmeansd:
            if meansd_out is None:
                # the reference writes X_meansd after EVERY mode
                m_, s_ = ds.snp_stats(args.standx)
                meansd_out = np.column_stack([m_, s_])
            save_text(
                meansd_out, out["meansd"],
                colnames=["SNP" + TXT_SEP + "RefAllele", "Mean", "SD"],
                rownames=snp_rownames(), precision=prec)

        print(timestamp() + "Goodbye!")
        return 0
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 -- the CLI's error boundary
        print(timestamp() + f"Exception: {e}", file=sys.stderr)
        print(timestamp() + "Terminating", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
