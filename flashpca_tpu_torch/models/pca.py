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

This package ports the wide, device-resident, single-device path: a
PLINK fileset or a prebuilt :class:`PackedOperator`.  The tall path,
streaming, multi-GPU, dense matrix input, ``batch=True`` and mid-run
checkpoints raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.plink import PlinkDataset
from ..ops.operator import (PackedOperator, build_packed_operator,
                            check_operator_conflicts)
from ..solvers.block_lanczos import eigsh_block, polish_subspace
from ..utils.device import host64
from ._common import not_ported
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


def pca(data, ndim: int = 10, *, stand: str = "binom2", divisor: str = "p",
        maxiter: int = 500, tol: float = 1e-6, seed: int = 1,
        block_size: int | None = None, do_loadings: bool = False,
        dtype=None, device=None, mesh=None, batch: bool = False,
        ncv: int | None = None, panel: int = 16, verbose: bool = False,
        operator_mode: str = "auto", streaming="auto",
        memory_mb: int | None = None, device_results: bool = False,
        state_in: str | None = None, state_out: str | None = None,
        checkpoint_every: int = 0, polish: str = "contract") -> PCAResult:
    """Compute the top ``ndim`` principal components.

    ``data`` is a PLINK root path / :class:`PlinkDataset` or a prebuilt
    :class:`PackedOperator` (e.g. genotypes generated on the card).
    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the PyTorch CPU path (float64 by default).

    ``polish`` is the accuracy/speed knob for float32 runs:

    * ``"contract"`` (default): a FIXED-SCHEDULE capped solve (8 thick
      restarts, ndim + up to 4 buffer pairs) finished with the
      compensated (two-float) Krylov refinement; a two-float residual
      gate computes ``check()``'s mse statistic with no extra data pass,
      accepts under 7e-9, deepens by one more refinement if missed, and
      falls back to the full adaptive solve if still missed -- meeting
      the reference's ``--check`` contract (mse < 1e-8) measurably.  The
      fixed schedule applies for ndim <= 32; larger ndim runs the
      adaptive schedule with 8 buffer pairs.
    * ``"fast"``: plain float32 solve + float32 subspace polish, about
      half the data passes; the residual floors at the float32
      product-noise level.

    At float64 both settings are identical.

    ``device_results=True`` keeps vectors/projection/loadings as device
    tensors.  ``state_out`` writes an .npz restart checkpoint (the Ritz
    panel in sample space) after the solve; ``state_in`` warm-starts
    from one (the JAX package's checkpoint format).
    """
    if polish not in ("contract", "fast"):
        raise ValueError(
            f"polish must be 'contract' or 'fast', got {polish!r}")
    if operator_mode not in ("auto", "wide", "tall"):
        raise ValueError(f"unknown operator_mode: {operator_mode}")
    if checkpoint_every:
        raise not_ported("checkpoint_every (mid-run checkpoints)",
                         "A17 'Checkpoints'")
    if batch:
        raise not_ported("batch=True (the dense in-RAM path)",
                         "A12 'Dense and matrix inputs'")
    if mesh is not None:
        raise not_ported("mesh= (multi-device sharding)", "A18 'Multi-GPU'")

    if isinstance(data, str):
        data = PlinkDataset.open(data)

    if isinstance(data, PackedOperator):
        check_operator_conflicts(data, dtype=dtype, streaming=streaming,
                                 memory_mb=memory_mb, block_size=block_size,
                                 device=device)
        if operator_mode == "tall":
            raise ValueError(
                "operator_mode='tall' conflicts with the prebuilt "
                "PackedOperator (a wide operator)")
        _check_ndim(ndim, data.n_samples, data.n_snps)
        return _pca_operator(
            data, ndim, divisor, maxiter, tol, seed, do_loadings, ncv,
            data.center, data.scale, panel=panel,
            device_results=device_results, state_in=state_in,
            state_out=state_out, verbose=verbose, polish=polish)

    if isinstance(data, PlinkDataset):
        if stand not in ("binom", "binom2"):
            raise ValueError(
                "When using PLINK data, you must use stand='binom' or "
                "'binom2'")
        n, p = data.n_samples, data.n_snps
        _check_ndim(ndim, n, p)
        if operator_mode == "tall" or (operator_mode == "auto" and n > 2 * p):
            raise not_ported(
                f"the tall path (X^T X; chosen for n={n} > 2p={2 * p} "
                "or operator_mode='tall'); pass operator_mode='wide' to "
                "decompose X X^T instead", "A16 'Tall path'")
        # one host pass yields (mean, sd) AND the exact per-SNP sum of
        # squares, so trace/pve cost no device data pass
        mean, sd, sumsq = data.snp_stats(stand, with_sumsq=True)
        op = build_packed_operator(
            data, mean, sd, streaming=streaming, memory_mb=memory_mb,
            block_size=block_size, dtype=dtype, device=device,
            snp_sumsq=sumsq)
        return _pca_operator(
            op, ndim, divisor, maxiter, tol, seed, do_loadings, ncv, mean,
            sd, panel=panel, device_results=device_results,
            state_in=state_in, state_out=state_out, verbose=verbose,
            polish=polish)

    raise not_ported("pca() on a numeric matrix",
                     "A12 'Dense and matrix inputs'")


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
    if state_out is not None:
        from ..solvers.lanczos import save_state

        save_state(state_out, op.unpermute(res.eigenvectors),
                   res.eigenvalues, res.residuals,
                   res.converged if converged is None else converged)


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
                  mean, sd, panel=16, device_results=False, state_in=None,
                  state_out=None, verbose=False,
                  polish="contract") -> PCAResult:
    n, p = op.n_samples, op.n_snps
    dtype = op.dtype
    div = _resolve_divisor(divisor, n, p)
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

    def solve(iters):
        return eigsh_block(mv, op.op_dim, nev_solve, block=panel, ncv=ncv,
                           maxiter=iters, tol=solver_tol, dtype=dtype,
                           device=op.device, seed=seed, v0=v0,
                           verbose=verbose)

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
                mv, U_dev, iters=2, ff_gram=ff_gram, return_resid=True)
            mse_est = float(np.sum((resid[:ndim] / div) ** 2) / (n * ndim))
            if not capped or mse_est < GATE_MSE:
                ok = capped or mse_est < 1e-8 or converged
                break
        if not ok and cap < maxiter:
            # the measured estimate missed the contract: rerun the
            # adaptive schedule from scratch (the capped attempt's
            # passes stay on the bill)
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
                return_resid=True)
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
        lam, U_dev = polish_subspace(mv, U_dev, iters=2)
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
        center=np.asarray(mean, dtype=np.float64),
        scale=np.asarray(sd, dtype=np.float64),
        loadings=loadings,
        converged=converged,
        n_ops=res.n_ops + n_ops_extra,
        n_restarts=res.n_restarts,
        residuals=resid_out,
        gate_mse=mse_est,
    )
