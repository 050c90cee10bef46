"""Command-line front end, flag-compatible with the reference binary.

Mirrors flashpca.cpp's option table (flashpca.cpp:40-92), checks
(:136-228), defaults (ndim=10, standx=binom2, div=p, tol=1e-6,
maxiter=500, seed=1, precision=7, suffix=.txt) and output files and
formats (:755-878) for the modes this package ports: PCA (the
default), ``--check``, ``--project`` (``--inload`` with ``--inmeansd``
or ``--inmaf``, written to ``--outproj``), ``--ucca`` (``--pheno``,
``--standy``, written to ucca.txt) and ``--scca`` (``--pheno``,
``--lambda1``, ``--lambda2``, ``--standy``, written to eigenvalues.txt,
eigenvectorsX/Y.txt and pcsX/Y.txt or ``--outvecx``, ``--outvecy``,
``--outpcx``, ``--outpcy``, and with ``--save-vinit`` the initial V to
scca_v0.txt); SCCA's own flags are accepted and unused in the other
modes, as by the JAX CLI.  ``--batch`` loads the genotypes
whole as a matrix for PCA and UCCA, held on ``--device`` (UCCA's in
float64 unless ``--dtype`` says otherwise).  ``--shards N`` shards the
packed operator over N devices in this process (the first N cards, or N
CPU shards with ``--device cpu``); ``--profile DIR`` writes a
``torch.profiler`` trace of the run (CPU and CUDA activities, with the
port's ``flashpca/`` spans, utils/trace.py) into DIR as a Chrome trace
file.  ``--stream on``
streams the operator from the host: the wide one in blocks of the
reference's ``--memory`` block size (or ``--blocksize``; about 1 GiB a
block without either), the tall one (``--opmode tall``) in blocks of
samples of about 1 GiB; as the JAX CLI, the tall one refuses the SNP
block size that ``--memory`` or ``--blocksize`` sets.  ``--debug`` is
the reference's no-op; ``--outstate``/``--instate`` write and resume the
JAX package's .npz checkpoints (PCA's Ritz panel, and SCCA's state after
every completed dimension), and ``--checkpoint-every R`` rewrites PCA's
after every R-th restart during the solve.  ``--device`` (default
``cuda``) selects the card or the CPU path, ``--dtype`` float32 (the
kernels) or float64 (the PyTorch functional core) on either.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import __version__
from .io.plink import PlinkDataset
from .io.text import maf2meansd, read_maf, read_text, save_text, TXT_SEP
from .models.check import check as run_check
from .models.pca import pca as run_pca
from .models.project import project as run_project
from .models.scca import scca as run_scca
from .models.ucca import ucca as run_ucca
from .utils.logging import log, set_show_timestamp, timestamp

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
                   help="perform sparse canonical correlation analysis "
                        "(SCCA)")
    p.add_argument("--ucca", action="store_true",
                   help="perform per-SNP canonical correlation analysis")
    p.add_argument("--project", "-p", action="store_true",
                   help="project new samples onto existing principal "
                        "components")
    p.add_argument("--check", "-c", action="store_true",
                   help="check eigenvalues/eigenvectors")
    p.add_argument("--batch", action="store_true",
                   help="load all genotypes into RAM at once (PCA/UCCA)")
    p.add_argument("--memory", "-m", type=int, default=None,
                   help="size of block, in MB")
    p.add_argument("--blocksize", "-b", type=int, default=None,
                   help="size of block, in number of SNPs")
    p.add_argument("--numthreads", "-n", type=int, default=None,
                   help="OpenMP threads for the native host IO kernels")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--bed"), p.add_argument("--bim"), p.add_argument("--fam")
    p.add_argument("--pheno")
    p.add_argument("--bfile")
    p.add_argument("--ndim", "-d", type=int, default=10)
    p.add_argument("--standx", "-s", default="binom2",
                   choices=["binom", "binom2"])
    p.add_argument("--standy", default="sd",
                   choices=["sd", "binom", "binom2", "none", "center"])
    p.add_argument("--div", default="p", choices=["p", "n1", "none"])
    p.add_argument("--outpc"), p.add_argument("--outpcx")
    p.add_argument("--outpcy"), p.add_argument("--outvec")
    p.add_argument("--outload"), p.add_argument("--outvecx")
    p.add_argument("--outvecy"), p.add_argument("--outval")
    p.add_argument("--outpve"), p.add_argument("--outmeansd")
    p.add_argument("--outproj")
    p.add_argument("--inload"), p.add_argument("--inmeansd")
    p.add_argument("--inmaf")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--lambda1", type=float, default=0.0,
                   help="SCCA penalty on X")
    p.add_argument("--lambda2", type=float, default=0.0,
                   help="SCCA penalty on Y")
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--debug", action="store_true",
                   help="accepted and ignored, as by the reference")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run (CPU and "
                        "CUDA activities) to DIR as a Chrome trace file "
                        "(view it in chrome://tracing or Perfetto)")
    p.add_argument("--suffix", "-f", default=".txt")
    p.add_argument("--precision", type=int, default=7)
    p.add_argument("--notime", action="store_true")
    p.add_argument("--save-vinit", action="store_true", dest="save_vinit",
                   help="write SCCA's initial V to scca_v0.txt")
    p.add_argument("--version", action="store_true")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="compute dtype (default: float32 on cuda, "
                        "float64 on cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or the CPU path")
    p.add_argument("--shards", type=int, default=None,
                   help="shard the packed genotypes over this many devices "
                        "(the first N cards, or N CPU shards with --device "
                        "cpu; default 1)")
    p.add_argument("--stream", default="auto",
                   choices=["auto", "on", "off"],
                   help="stream packed genotypes from host per block: "
                        "on the wide path blocks of the --memory or "
                        "--blocksize block size, on the tall path blocks "
                        "of samples ('auto': when the packed genotypes "
                        "exceed 0.7 x the card's memory)")
    p.add_argument("--outstate", metavar="FILE", default=None,
                   help="write an .npz restart checkpoint (PCA: the Ritz "
                        "panel after the solve; SCCA: after every "
                        "completed dimension; the JAX package's format)")
    p.add_argument("--instate", metavar="FILE", default=None,
                   help="warm-start PCA, or resume SCCA, from a "
                        "checkpoint written by --outstate")
    p.add_argument("--checkpoint-every", metavar="R", type=int, default=0,
                   help="PCA with --outstate: also rewrite the checkpoint "
                        "after every R-th restart during the solve (0 = "
                        "off)")
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
    if unknown:
        return _die("unrecognized arguments: " + " ".join(unknown))
    if mode == "project":
        if not args.inload:
            return _die("SNP-loadings must be specified using --inload")
        if not args.inmaf and not args.inmeansd:
            return _die("one of MAF or mean/stdev must be specified using "
                        "--inmaf or --inmeansd, respectively")
    if args.inmeansd and args.inmaf:
        return _die("conflicting options requested --inmeansd, --inmaf")
    if args.checkpoint_every:
        if args.checkpoint_every < 0:
            return _die("--checkpoint-every must be a positive restart "
                        "interval")
        if mode != "pca":
            return _die("--checkpoint-every applies to PCA mode only "
                        "(SCCA persists per completed dimension with "
                        "--outstate)")
        if not args.outstate:
            return _die("--checkpoint-every requires --outstate")
    if (args.outstate or args.instate) and mode not in ("pca", "scca"):
        return _die("--outstate/--instate apply to PCA and SCCA modes "
                    "only (this mode has no restart state)")
    stream = {"auto": "auto", "on": True, "off": False}[args.stream]
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
    if args.lambda1 < 0:
        return _die("--lambda1 can't be negative")
    if args.lambda2 < 0:
        return _die("--lambda2 can't be negative")
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
    if mode in ("scca", "ucca") and not args.pheno:
        return _die("you must specify a phenotype file in CCA/UCCA/SCCA "
                    "mode using --pheno")

    suffix = args.suffix
    out = {
        "pc": args.outpc or f"pcs{suffix}",
        "pcx": args.outpcx or f"pcsX{suffix}",
        "pcy": args.outpcy or f"pcsY{suffix}",
        "vec": args.outvec or f"eigenvectors{suffix}",
        "vecx": args.outvecx or f"eigenvectorsX{suffix}",
        "vecy": args.outvecy or f"eigenvectorsY{suffix}",
        "val": args.outval or f"eigenvalues{suffix}",
        "pve": args.outpve or f"pve{suffix}",
        "meansd": args.outmeansd or f"meansd{suffix}",
        "proj": args.outproj or f"projection{suffix}",
        "ucca": f"ucca{suffix}",
        "load": args.outload,
    }
    prec = args.precision

    mesh = None
    nshards = args.shards if args.shards is not None else 1
    if args.shards is not None and args.device == "cuda":
        import torch

        ndev = torch.cuda.device_count()
        if nshards > ndev:
            # never clamp silently: the user sized per-device memory on it
            return _die(f"--shards {nshards} exceeds the {ndev} available "
                        f"device(s)")
    if nshards < 1:
        return _die(f"--shards must be >= 1 (got {nshards})")
    if nshards > 1:
        from .parallel import snp_mesh

        mesh = snp_mesh([f"cuda:{i}" for i in range(nshards)]
                        if args.device == "cuda" else ["cpu"] * nshards)

    profiler = _profiler(args.profile) if args.profile else None
    try:
        ds = PlinkDataset.open(bed, bim, fam)
        log(f"Detected BED file: {bed} with N={ds.n_samples} samples, "
            f"{ds.n_snps} SNPs", verbose=args.verbose)

        Y = None
        if mode in ("scca", "ucca"):
            # the reference reads --pheno only for (S)CCA/UCCA and the
            # .fam phenotype otherwise (flashpca.cpp:585-588): a stale
            # --pheno on another mode's command line is ignored
            Y = read_text(args.pheno, firstcol=3)
            if Y.shape[0] != ds.n_samples:
                return _die("phenotype file rows must match .fam rows")

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
        maf = meansd = None
        if mode == "pca":
            print(timestamp() + "PCA begin")
            res = run_pca(
                ds, args.ndim, stand=args.standx, divisor=args.div,
                maxiter=args.maxiter, tol=args.tol, seed=args.seed,
                block_size=block_size, do_loadings=bool(args.outload),
                dtype=args.dtype, device=args.device, batch=args.batch,
                mesh=mesh, verbose=args.verbose, operator_mode=args.opmode,
                polish=args.polish, streaming=stream,
                memory_mb=args.memory, state_in=args.instate,
                state_out=args.outstate,
                checkpoint_every=args.checkpoint_every)
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
        elif mode == "scca":
            print(timestamp() + "SCCA begin")
            res = run_scca(
                ds, Y, args.lambda1, args.lambda2, ndim=args.ndim,
                stand_x=args.standx, stand_y=args.standy, divisor=args.div,
                maxiter=args.maxiter, tol=args.tol, seed=args.seed,
                block_size=block_size, dtype=args.dtype, device=args.device,
                mesh=mesh, verbose=args.verbose, streaming=stream,
                memory_mb=args.memory, state_out=args.outstate,
                state_in=args.instate)
            print(timestamp() + "SCCA done")
            if not res.converged:
                print(timestamp() + "SCCA did not converge")
            if args.save_vinit:
                save_text(res.V0, "scca_v0.txt", precision=prec)
            save_text(res.d.reshape(-1, 1), out["val"], precision=prec)
            save_text(res.U, out["vecx"], precision=prec)
            save_text(res.V, out["vecy"], precision=prec)
            save_text(res.Px, out["pcx"], precision=prec)
            save_text(res.Py, out["pcy"], precision=prec)
        elif mode == "ucca":
            print(timestamp() + "UCCA begin")
            if args.batch:
                res = run_ucca(ds.read_matrix(), Y, stand_x=args.standx,
                               stand_y=args.standy, dtype=args.dtype,
                               device=args.device, mesh=mesh)
            else:
                res = run_ucca(ds, Y, stand_x=args.standx,
                               stand_y=args.standy, block_size=block_size,
                               dtype=args.dtype, device=args.device,
                               mesh=mesh, streaming=stream,
                               memory_mb=args.memory)
            print(timestamp() + "UCCA done")
            save_text(res.result, out["ucca"],
                      colnames=["SNP", "R", "Fstat", "P"],
                      rownames=list(ds.snp_ids), precision=prec)
        elif mode == "project":
            V = read_text(args.inload, firstcol=3, skip=1)
            if args.inmaf:
                maf = read_maf(args.inmaf, ds.snp_ids)
            else:
                meansd = read_text(args.inmeansd, firstcol=3, skip=1)
            res = run_project(ds, V, meansd=meansd, maf=maf,
                              divisor=args.div, stand=args.standx,
                              block_size=block_size, dtype=args.dtype,
                              device=args.device, mesh=mesh,
                              streaming=stream, memory_mb=args.memory)
            pccol = ["FID" + TXT_SEP + "IID"] + [
                f"PC{i+1}" for i in range(res.projection.shape[1])]
            save_text(res.projection, out["proj"], colnames=pccol,
                      rownames=fam_rownames(), precision=prec)
        else:  # check
            eval_ = read_text(out["val"], firstcol=1, skip=0)[:, 0]
            evec = read_text(out["vec"], firstcol=3, skip=1)
            res = run_check(ds, evec, eval_, stand=args.standx,
                            divisor=args.div, block_size=block_size,
                            dtype=args.dtype, device=args.device, mesh=mesh,
                            streaming=stream, memory_mb=args.memory)
            for j in range(len(res.err)):
                print(timestamp() + f"eval({j+1}): {eval_[j]}, "
                      f"sum squared error: {res.err[j]}")
            print(timestamp() + f"Mean squared error: {res.mse}, "
                  f"Root mean squared error: {res.rmse} "
                  f"(n={ds.n_samples})")

        if args.outmeansd:
            if meansd_out is None and mode == "project":
                # the stats the projection standardized with: the loaded
                # ones, or those derived from the MAFs
                ms = maf2meansd(maf) if maf is not None else meansd
                meansd_out = np.asarray(ms, dtype=np.float64)
            elif meansd_out is None:
                # the reference writes X_meansd after EVERY mode
                # (flashpca.cpp:867-878, outside the mode switch)
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
    finally:
        if profiler is not None:
            profiler.stop()      # writes the trace


def _profiler(outdir):
    """A started ``torch.profiler`` over the CPU (and CUDA, when a card
    is present) activities that writes a Chrome trace file into
    ``outdir`` when it stops."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(outdir))
    prof.start()
    return prof


if __name__ == "__main__":
    sys.exit(main())
