"""PCA entry point: top-k PCs of standardized genotype data.

Equivalent of ``RandomPCA::pca_fast`` (reference: randompca.cpp:121-218)
with identical post-processing:

* ``values  d   = eigenvalues(X X^T) / div``  (div in {p, n-1, 1})
* ``vectors U   = eigenvectors``               (N x k)
* ``projection  Px = U diag(sqrt(d))``
* ``loadings V  = X^T U diag(1/sqrt(d)) / sqrt(div)``
* ``trace = sum X^2 / div``, ``pve = d / trace``

plus the dimension cap ``ndim <= (min(N, p) - 1) / 2``
(flashpca.cpp:614-633).

Inputs: a PLINK fileset (the packed wide gram X X^T, resident or
streamed from the host, or the tall gram X^T X, taken by
``operator_mode="auto"`` when n > 2p), a numeric (N, p) matrix or
``batch=True`` (standardized on the host and held whole by a
:class:`DenseOperator`), or any prebuilt operator of those.  ``mesh=``
shards the packed operator over several devices or processes
(parallel/dist.py); the dense path runs unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.plink import PlinkDataset
from ..ops.operator import (TALL_OPERATORS, WIDE_OPERATORS, DenseOperator,
                            build_packed_operator, check_operator_conflicts)
from ..ops.standardize import standardize
from ..solvers.block_lanczos import eigsh_block, polish_subspace
from ..parallel.dist import agree_fn, barrier, writer
from ..utils.device import host64
from ..utils.trace import span, traced
from ._common import note_unsharded
from ._common import resolve_divisor as _resolve_divisor

DIVISORS = ("p", "n1", "none")

# the contract gate of the fixed-schedule path: accept the capped solve
# when the refinement's own two-float residuals give check()'s mse
# statistic below this (the contract is mse < 1e-8)
GATE_MSE = 7e-9


@dataclass
class PCAResult:
    values: np.ndarray
    vectors: np.ndarray
    projection: np.ndarray
    pve: np.ndarray
    trace: float
    center: np.ndarray
    scale: np.ndarray
    loadings: np.ndarray | None = None
    converged: bool = True
    n_ops: int = 0
    n_restarts: int = 0
    residuals: np.ndarray | None = None
    # the contract gate's last mse estimate (None when no gate ran)
    gate_mse: float | None = None

    def __repr__(self):
        return f"PCAResult(ndim={len(self.values)}, converged={self.converged})"


def _check_ndim(ndim: int, n: int, p: int) -> None:
    if ndim < 1:
        raise ValueError("ndim can't be less than 1")
    max_dim = int((min(n, p) - 1) / 2.0)
    if ndim > max_dim:
        raise ValueError(
            f"You asked for {ndim} dimensions, but only {max_dim} allowed")


@traced("pca")
def pca(data, ndim: int = 10, *, stand: str = "binom2", divisor: str = "p",
        maxiter: int = 500, tol: float = 1e-6, seed: int = 1,
        block_size: int | None = None, do_loadings: bool = False,
        dtype=None, device=None, mesh=None, batch: bool = False,
        check_geno: bool = True, ncv: int | None = None, panel: int = 16,
        verbose: bool = False, operator_mode: str = "auto",
        streaming="auto", memory_mb: int | None = None,
        device_results: bool = False, state_in: str | None = None,
        state_out: str | None = None, checkpoint_every: int = 0,
        polish: str = "contract") -> PCAResult:
    """Compute the top ``ndim`` principal components.

    ``data`` is a PLINK root path / :class:`PlinkDataset` (the packed
    path; ``stand`` must be binom or binom2), a numeric (N, p) matrix
    (any ``stand``; NaN is missing and mean-imputed; ``check_geno``
    refuses values other than 0, 1, 2 under binom/binom2), or a prebuilt
    :class:`PackedOperator` / :class:`StreamingPackedOperator` /
    :class:`TallPackedOperator` / :class:`TallStreamingOperator` /
    :class:`DenseOperator` (e.g. genotypes generated on the card).
    ``batch=True`` loads a PLINK fileset whole as a matrix (the
    reference's ``--batch``).  ``operator_mode`` picks the gram for
    PLINK input: ``"wide"`` (X X^T), ``"tall"`` (X^T X, for n >> p) or
    ``"auto"`` (tall when n > 2p).  ``streaming`` (``"auto"``, True,
    False) streams the gram's bytes from the host in blocks, of SNPs on
    the wide path and of samples on the tall one (``"auto"``: when they
    exceed 0.7 x the card's memory); ``memory_mb`` bounds the two device
    block buffers it stages through (the CLI's ``--memory``).
    ``block_size`` sets the wide streaming path's SNPs a block and
    raises on the tall one.
    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the PyTorch CPU path (float64 by default).
    ``mesh`` (a :class:`~flashpca_tpu_torch.parallel.Mesh`) shards the
    packed operator: SNP rows on the wide gram, samples on the tall
    one.  Across processes every process calls ``pca`` alike and gets
    the same result; only rank 0 writes ``state_out``.

    ``polish`` is the accuracy/speed knob for float32 runs:

    * ``"contract"`` (default): a FIXED-SCHEDULE capped solve (8 thick
      restarts, ndim + up to 4 buffer pairs) finished with the
      compensated (two-float) Krylov refinement; a two-float residual
      gate computes ``check()``'s mse statistic with no extra data pass,
      accepts under 7e-9, deepens by one more refinement if missed, and
      falls back to the full adaptive solve if still missed -- meeting
      the reference's ``--check`` contract (mse < 1e-8) measurably.  The
      fixed schedule applies on the wide path for ndim <= 32; larger
      ndim runs the adaptive schedule with 8 buffer pairs, and the tall
      path keeps the adaptive schedule and one compensated polish
      throughout.
    * ``"fast"``: plain float32 solve + float32 subspace polish, about
      half the data passes; the residual floors at the float32
      product-noise level.

    At float64 both settings are identical.

    ``device_results=True`` keeps vectors/projection/loadings as device
    tensors.  ``state_out`` writes an .npz restart checkpoint (the Ritz
    panel of the solved gram: n sample rows on the wide path, p SNP rows
    on the tall one) after the solve; ``state_in`` warm-starts from one
    (the JAX package's checkpoint format).  ``checkpoint_every=R`` also
    rewrites ``state_out`` after every R-th thick restart DURING the
    solve, so a killed process resumes from its last checkpoint.
    """
    if polish not in ("contract", "fast"):
        raise ValueError(
            f"polish must be 'contract' or 'fast', got {polish!r}")
    if operator_mode not in ("auto", "wide", "tall"):
        raise ValueError(f"unknown operator_mode: {operator_mode}")
    if checkpoint_every:
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be a positive restart interval, "
                f"got {checkpoint_every}")
        if state_out is None:
            raise ValueError(
                "checkpoint_every requires state_out (a path to write "
                "the mid-run checkpoints to)")
    run_kw = dict(panel=panel, device_results=device_results,
                  state_in=state_in, state_out=state_out, verbose=verbose,
                  polish=polish, checkpoint_every=checkpoint_every)

    if isinstance(data, str):
        data = PlinkDataset.open(data)

    if isinstance(data, (*WIDE_OPERATORS, *TALL_OPERATORS)):
        check_operator_conflicts(data, dtype=dtype, streaming=streaming,
                                 memory_mb=memory_mb, block_size=block_size,
                                 device=device, mesh=mesh)
        if batch:
            raise ValueError("batch=True has no effect on a prebuilt operator")
        # the decomposition shape is fixed by the operator class too
        if operator_mode != "auto" and (operator_mode == "tall") != (
                isinstance(data, TALL_OPERATORS)):
            raise ValueError(
                f"operator_mode={operator_mode!r} conflicts with the "
                f"prebuilt {type(data).__name__}; build the matching "
                "operator class instead")
        _check_ndim(ndim, data.n_samples, data.n_snps)
        op = data
    elif isinstance(data, PlinkDataset):
        if stand not in ("binom", "binom2"):
            raise ValueError(
                "When using PLINK data, you must use stand='binom' or "
                "'binom2'")
        n, p = data.n_samples, data.n_snps
        _check_ndim(ndim, n, p)
        if batch:
            # the reference's --batch loads the whole matrix and ignores
            # the memory budget (flashpca.cpp:230-235): say so when the
            # caller asked for bounded memory
            if streaming is True or memory_mb is not None:
                from ..utils.logging import log

                log("note: batch=True loads the whole matrix; the "
                    "streaming/memory_mb request is ignored (reference "
                    "--batch semantics)")
            if operator_mode == "tall":
                raise ValueError(
                    "operator_mode='tall' has no batch (dense) "
                    "implementation; drop batch=True for the tall path")
            if device_results:
                raise ValueError(
                    "device_results=True is not supported on the batch "
                    "(dense) path; use the packed path or a prebuilt "
                    "operator")
            return _pca_matrix(data.read_matrix(), ndim, stand, divisor,
                               maxiter, tol, seed, do_loadings, ncv, dtype,
                               device, mesh, **run_kw)
        # one host pass yields (mean, sd) AND the exact per-SNP sum of
        # squares, so trace/pve cost no device data pass
        mean, sd, sumsq = data.snp_stats(stand, with_sumsq=True)
        # n >> p: decompose the p x p gram X^T X instead of X X^T
        op = build_packed_operator(
            data, mean, sd, tall=operator_mode == "tall" or (
                operator_mode == "auto" and n > 2 * p),
            streaming=streaming, memory_mb=memory_mb, block_size=block_size,
            dtype=dtype, device=device, mesh=mesh, snp_sumsq=sumsq)
    else:
        # a numeric matrix: packed-path and device-residency requests
        # cannot be honoured, so they raise instead of being dropped
        if streaming is True or memory_mb is not None:
            raise ValueError(
                "streaming=True / memory_mb apply to packed (PLINK) data; "
                "a dense matrix X is held in device memory whole")
        if operator_mode == "tall":
            raise ValueError(
                "operator_mode='tall' is a packed-path option; the dense "
                "matrix path has no tall operator")
        if device_results:
            raise ValueError(
                "device_results=True is not supported on the dense matrix "
                "path; standardize and build a DenseOperator, then call "
                "pca(op, ...) for device-resident results")
        X = np.asarray(data, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError("X must be a 2-D matrix")
        if X.shape[1] < 2 or X.shape[0] < 2:
            raise ValueError("X must have at least two rows and columns")
        if stand in ("binom", "binom2") and check_geno:
            ok = np.isnan(X) | np.isin(X, (0.0, 1.0, 2.0))
            if not ok.all():
                raise ValueError(
                    "Your data contains values other than {0, 1, 2}, "
                    "stand='binom'/'binom2' can't be used here")
        _check_ndim(ndim, X.shape[0], X.shape[1])
        return _pca_matrix(X, ndim, stand, divisor, maxiter, tol, seed,
                           do_loadings, ncv, dtype, device, mesh, **run_kw)

    run = _pca_tall if isinstance(op, TALL_OPERATORS) else _pca_operator
    return run(op, ndim, divisor, maxiter, tol, seed, do_loadings, ncv,
               **run_kw)


def _pca_matrix(X, ndim, stand, divisor, maxiter, tol, seed, do_loadings,
                ncv, dtype, device, mesh, **run_kw) -> PCAResult:
    """A numeric matrix: standardized on the host in float64 (NaN
    mean-imputed), then held whole by a :class:`DenseOperator` that
    reports the stats it was standardized with.  A ``mesh`` is noted and
    not used: the dense path has no sharded implementation."""
    note_unsharded(mesh, "(batch) PCA")
    X_std, mean, sd = standardize(X, stand)
    op = DenseOperator(torch.from_numpy(X_std), dtype=dtype, device=device,
                       center=mean, scale=sd)
    del X_std
    return _pca_operator(op, ndim, divisor, maxiter, tol, seed, do_loadings,
                         ncv, **run_kw)


def _solver_v0(op, native_len, seed, state_in):
    """Initial vector/panel in the operator's permuted space: a
    warm-start Ritz panel from a checkpoint, else seeded random (drawn
    and permuted on the host)."""
    if state_in is not None:
        from ..solvers.lanczos import load_state

        panel = load_state(state_in)["vectors"]
        if panel.shape[0] != native_len:
            raise ValueError(
                f"restart state has {panel.shape[0]} rows; expected "
                f"{native_len}")
        return op.permute_np(panel)
    rng = np.random.default_rng(seed)
    return op.permute_np(rng.standard_normal(native_len))


def _save_solver_state(op, res, state_out, converged=None):
    """Write the restart state: rank 0 of a mesh's processes writes, the
    others wait for it."""
    if state_out is not None:
        from ..solvers.lanczos import save_state

        if writer(op):
            save_state(state_out, op.unpermute(res.eigenvectors),
                       res.eigenvalues, res.residuals,
                       res.converged if converged is None else converged)
        barrier(op)


def _mid_run_checkpointer(op, state_out, checkpoint_every):
    """Solver callback persisting the current Ritz panel every R-th
    restart, marked not converged (mid-run fault tolerance: it survives
    the death of the process, not just a maxiter cap).  None when not
    requested."""
    if state_out is None or checkpoint_every <= 0:
        return None
    from ..solvers.lanczos import save_state
    from ..utils.logging import log

    log(f"mid-run checkpoints every {checkpoint_every} restart(s) -> "
        f"{state_out} (each copies the Ritz panel to the host)")

    def ckpt(panel, values, residuals):
        if writer(op):
            save_state(state_out, op.unpermute(panel), values, residuals,
                       False)
        barrier(op)

    return ckpt


def _clamp_buffer(extra, ndim, ncv, panel):
    """Cap the buffer-pair count so a USER-pinned basis keeps the block
    solver viable (eigsh_block falls back to scalar Lanczos when
    nev + panel > ncv); compared against the PANEL-ROUNDED basis."""
    if ncv is None:
        return extra
    ncv, panel = int(ncv), int(panel)
    ncv_eff = panel * (ncv // panel) if ncv % panel else ncv
    return max(0, min(extra, ncv_eff - panel - int(ndim)))


def _clamp_auto_ncv(ncv, ndim, extra, panel, op_dim):
    """Keep the AUTO ff basis inside the block solver's viability guard
    (``ncv + 2*panel <= op_dim`` in whole panels): a small problem must
    not be pushed to scalar Lanczos by the internal basis inflation
    alone.  Shrinks the buffer with the basis; returns
    (ncv, extra, nev_solve)."""
    ncv_max = panel * ((op_dim - 2 * panel) // panel)
    if ncv > ncv_max >= ndim + panel:
        ncv = ncv_max
        extra = _clamp_buffer(extra, ndim, ncv, panel)
    return ncv, extra, ndim + extra


def _gate_convergence(res, ndim, tol):
    """Requested pairs govern success; buffer pairs are best-effort.
    Returns the converged flag for the PCAResult, or raises when a
    requested pair failed."""
    if res.converged:
        return True
    mask = res.conv_mask
    nsolve = len(res.residuals)
    if (mask is not None and len(mask) >= ndim
            and bool(np.all(mask[:ndim]))):
        from ..utils.logging import log

        miss = int(np.sum(~np.asarray(mask[ndim:], dtype=bool)))
        log(f"note: {miss}/{nsolve - ndim} buffer pair(s) missed "
            "tolerance by maxiter; the requested pairs converged (max "
            f"residual {float(np.max(res.residuals[:ndim])):.3e}) -- "
            "continuing (the compensated polish may land slightly "
            "above the check contract; check() measures it)")
        return True
    raise RuntimeError(
        "eigen-decomposition was not successful: max residual "
        f"{float(np.max(res.residuals[:ndim])):.3e} over the {ndim} "
        f"requested pair(s) after {res.n_restarts} restarts "
        f"(buffer={nsolve - ndim}, max residual "
        f"{float(np.max(res.residuals)):.3e} incl. buffers, tol={tol})")


def _pca_operator(op, ndim, divisor, maxiter, tol, seed, do_loadings, ncv,
                  panel=16, device_results=False, state_in=None,
                  state_out=None, verbose=False, polish="contract",
                  checkpoint_every=0) -> PCAResult:
    n, p = op.n_samples, op.n_snps
    dtype = op.dtype
    div = _resolve_divisor(divisor, n, p)
    with span("pca/start"):
        v0 = _solver_v0(op, n, seed, state_in)

    use_ff = dtype == torch.float32 and polish == "contract"
    # fixed-schedule contract regime: validated for ndim <= 32 (restarts
    # cost ~ncv/panel passes each, so large ndim keeps the adaptive one)
    capped = use_ff and ndim <= 32
    # buffer pairs beyond ndim, SOLVED alongside the requested ones, so
    # the compensated polish cleans the boundary pairs like interior
    # ones: 4 on the fixed schedule, 8 on the adaptive one
    max_dim = int((min(n, p) - 1) / 2.0)
    extra = min(4 if capped else 8, max(0, max_dim - ndim)) if use_ff else 0
    extra = _clamp_buffer(extra, ndim, ncv, panel)
    nev_solve = ndim + extra
    if use_ff and ncv is None:
        # absolute headroom beyond the solved pairs (~72 columns at
        # panel 16) plus proportional room for large nev
        ncv = nev_solve + max(72, (3 * nev_solve) // 2)
        ncv, extra, nev_solve = _clamp_auto_ncv(
            ncv, ndim, extra, panel, op.op_dim)
    # with the ff polish running, the solver only builds SPAN: driving
    # the float32 solve past ~1e-4 burns data passes
    solver_tol = max(tol, 1e-4) if use_ff else tol
    mv = op.gram_permuted
    ckpt = _mid_run_checkpointer(op, state_out, checkpoint_every)
    agree = agree_fn(op)

    def solve(iters):
        return eigsh_block(mv, op.op_dim, nev_solve, block=panel, ncv=ncv,
                           maxiter=iters, tol=solver_tol, dtype=dtype,
                           device=op.device, seed=seed, v0=v0,
                           verbose=verbose, checkpoint_every=checkpoint_every,
                           checkpoint_fn=ckpt, agree=agree)

    # fixed schedule: cap the float32 solve at 8 thick restarts
    cap = min(8, maxiter) if capped else maxiter
    res = solve(cap)
    _save_solver_state(op, res, state_out)
    # the failure gate applies to ADAPTIVE solves; a capped
    # span-building solve is expected to stop short, and the
    # ff-residual gate below measures what it delivered
    converged = (_gate_convergence(res, ndim, tol)
                 if not capped else res.converged)

    lam = res.eigenvalues
    U_dev = res.eigenvectors
    resid_out = res.residuals[:ndim]
    n_ops_extra = 0
    mse_est = None
    if use_ff:
        ff_gram = op.gram_ff_permuted
        ok = False
        for _ in range(2 if capped else 1):
            lam, U_dev, resid = polish_subspace(
                mv, U_dev, iters=2, ff_gram=ff_gram, return_resid=True,
                agree=agree)
            mse_est = float(np.sum((resid[:ndim] / div) ** 2) / (n * ndim))
            if not capped or mse_est < GATE_MSE:
                ok = capped or mse_est < 1e-8 or converged
                break
        if not ok and cap < maxiter:
            # the measured estimate missed the contract: rerun the
            # adaptive schedule from scratch (the capped attempt's
            # passes stay on the bill)
            with span("pca/fallback"):
                if verbose:
                    from ..utils.logging import log

                    log(f"pca: capped schedule missed the contract "
                        f"(mse_est {mse_est:.2e}); falling back to the "
                        "adaptive solve")
                n_ops_extra = res.n_ops
                res = solve(maxiter)
                _save_solver_state(op, res, state_out)
                converged = _gate_convergence(res, ndim, tol)
                lam, U_dev, resid = polish_subspace(
                    mv, res.eigenvectors, iters=2, ff_gram=ff_gram,
                    return_resid=True, agree=agree)
                mse_est = float(np.sum((resid[:ndim] / div) ** 2) / (n * ndim))
                ok = mse_est < 1e-8
        elif not ok:
            # the user capped maxiter at/below the schedule and the gate
            # missed: the adaptive path's failure semantics apply
            converged = _gate_convergence(res, ndim, tol)
        converged = bool(ok) or converged
        resid_out = resid[:ndim]
        if capped and ok and not res.converged:
            # the persisted state carries the DELIVERED outcome
            _save_solver_state(op, res, state_out, converged=True)
    elif dtype == torch.float32:
        # polish='fast': fresh subspace sweeps + host-float64
        # Rayleigh-Ritz recover accuracy near the float32 noise floor
        lam, U_dev = polish_subspace(mv, U_dev, iters=2, agree=agree)
    with span("pca/finish"):
        # drop the buffer pairs: only the requested dimensions are returned
        lam = lam[:ndim]
        U_dev = U_dev[:, :ndim]
        d = lam / div
        trace = op.trace / div
        pve = d / trace

        U_unperm = op.unpermute(U_dev)
        loadings = None
        if device_results:
            U = U_unperm
            Px = U * torch.as_tensor(np.sqrt(d), device=U.device).to(U.dtype)
            if do_loadings:
                Vt = op.crossprod(U)
                loadings = Vt * torch.as_tensor(
                    1.0 / np.sqrt(d) / np.sqrt(div), device=Vt.device
                ).to(Vt.dtype)[None, :]
        else:
            U = host64(U_unperm)
            if do_loadings:
                Vt = host64(op.crossprod(U_unperm))
                loadings = Vt * (1.0 / np.sqrt(d) / np.sqrt(div))[None, :]
            Px = U * np.sqrt(d)[None, :]

    return PCAResult(
        values=d,
        vectors=U,
        projection=Px,
        pve=pve,
        trace=trace,
        center=op.center,
        scale=op.scale,
        loadings=loadings,
        converged=converged,
        n_ops=res.n_ops + n_ops_extra,
        n_restarts=res.n_restarts,
        residuals=resid_out,
        gate_mse=mse_est,
    )


def _pca_tall(op, ndim, divisor, maxiter, tol, seed, do_loadings, ncv,
              panel=16, device_results=False, state_in=None,
              state_out=None, verbose=False, polish="contract",
              checkpoint_every=0) -> PCAResult:
    """Tall path: eigenpairs of X^T X, with the wide path's outputs:
    lambda(X^T X) = lambda(X X^T) on the top spectrum,
    U = X V_s Lambda^{-1/2}, and the loadings V equal V_s exactly
    (V = X^T U diag(1/sqrt(d))/sqrt(div) = V_s, randompca.cpp:151-152).
    The schedule is the adaptive one (no cap, no gate) with one
    compensated polish, as in the JAX package."""
    n, p = op.n_samples, op.n_snps
    dtype = op.dtype
    div = _resolve_divisor(divisor, n, p)
    with span("pca/start"):
        v0 = _solver_v0(op, p, seed, state_in)

    f32 = dtype == torch.float32
    use_ff = f32 and op.supports_ff and polish == "contract"
    if polish == "contract" and f32 and not use_ff:
        from ..utils.logging import log

        log("note: this tall operator has no compensated (ff) kernel "
            "support; the f32 result floors at plain precision "
            "(check mse ~2e-8 at biobank scale, above the mse < 1e-8 "
            "contract) -- build the operator with use_kernels=True for "
            "contract-grade accuracy")
    max_dim = int((min(n, p) - 1) / 2.0)
    extra = min(8, max(0, max_dim - ndim)) if use_ff else 0
    extra = _clamp_buffer(extra, ndim, ncv, panel)
    nev_solve = ndim + extra
    if use_ff and ncv is None:
        ncv = nev_solve + max(72, (3 * nev_solve) // 2)
        ncv, extra, nev_solve = _clamp_auto_ncv(
            ncv, ndim, extra, panel, op.op_dim)
    solver_tol = max(tol, 1e-4) if use_ff else tol
    mv = op.gram_permuted

    agree = agree_fn(op)
    res = eigsh_block(mv, op.op_dim, nev_solve, block=panel, ncv=ncv,
                      maxiter=maxiter, tol=solver_tol, dtype=dtype,
                      device=op.device, seed=seed, v0=v0, verbose=verbose,
                      checkpoint_every=checkpoint_every,
                      checkpoint_fn=_mid_run_checkpointer(
                          op, state_out, checkpoint_every), agree=agree)
    _save_solver_state(op, res, state_out)
    converged = _gate_convergence(res, ndim, tol)

    lam = res.eigenvalues
    V_dev = res.eigenvectors
    if f32:
        lam, V_dev = polish_subspace(
            mv, V_dev, iters=2,
            ff_gram=op.gram_ff_permuted if use_ff else None, agree=agree)
    with span("pca/finish"):
        lam = lam[:ndim]
        V_dev = V_dev[:, :ndim]
        d = lam / div
        trace = op.trace / div
        pve = d / trace

        Vs_dev = op.unpermute(V_dev)
        if device_results:
            Vs = Vs_dev
            U = op.prod(Vs_dev) * torch.as_tensor(
                1.0 / np.sqrt(lam), device=op.device).to(dtype)[None, :]
            Px = U * torch.as_tensor(np.sqrt(d), device=op.device).to(dtype)
        else:
            U = host64(op.prod(Vs_dev)) / np.sqrt(lam)[None, :]
            Px = U * np.sqrt(d)[None, :]
            Vs = host64(Vs_dev) if do_loadings else None

    return PCAResult(
        values=d,
        vectors=U,
        projection=Px,
        pve=pve,
        trace=trace,
        center=op.center,
        scale=op.scale,
        loadings=Vs if do_loadings else None,
        converged=converged,
        n_ops=res.n_ops,
        n_restarts=res.n_restarts,
        residuals=res.residuals[:ndim],
    )


def flashpca(X, ndim=10, stand="binom2", divisor="p", maxiter=100,
             tol=1e-4, seed=1, block_size=1000, verbose=False,
             do_loadings=False, check_geno=True, **kw) -> PCAResult:
    """Alias with the R package's defaults (flashpcaR/R/flashpca.R:99-103).

    ``block_size`` keeps the R default (1000) for the signature but only
    reaches ``pca()`` for PLINK input, where it means SNPs per block: a
    matrix has no blocking, and a prebuilt operator's geometry is fixed
    at construction (the R default would trip its conflict check)."""
    if isinstance(X, (str, PlinkDataset)):
        kw.setdefault("block_size", block_size)
    return pca(X, ndim, stand=stand, divisor=divisor, maxiter=maxiter,
               tol=tol, seed=seed, do_loadings=do_loadings,
               check_geno=check_geno, verbose=verbose, **kw)
