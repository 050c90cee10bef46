"""Thick-restart Lanczos eigensolver for symmetric PSD operators.

The replacement for the reference's Spectra
``SymEigsSolver<double, LARGEST_ALGE, Op>(&op, ndim, 2*ndim+1)``
(randompca.cpp:131-142, 173-178), with the same semantics:

* ``nev`` (= ndim) largest-algebraic eigenpairs of a symmetric operator,
* a Krylov subspace of ``ncv = 2*nev + 1`` vectors,
* ``maxiter`` restart cycles; convergence when the Ritz residual
  ``|beta_m * s_mi|`` drops below
  ``max(eps^(2/3) * theta_max, tol * |theta_i|)`` -- Spectra's
  criterion with the roundoff floor scaled by ||A|| (theta_max)
  instead of each pair's own |theta_i|.

The block solver (block_lanczos.py) calls this for problems too small
for panels.  The basis is a fixed-shape (n, ncv+1) device tensor with
full (CGS2) reorthogonalization; the small (ncv x ncv) projected
problem is solved on the host in float64.  An exact breakdown
(invariant subspace) splices in a fresh random direction with zero
coupling, drawn from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils.device import host64


@dataclass
class EigshResult:
    eigenvalues: np.ndarray       # (k,) descending, float64
    eigenvectors: torch.Tensor    # (n, k) device tensor, operator dtype
    n_restarts: int
    n_ops: int
    converged: bool
    residuals: np.ndarray         # (k,) estimated |beta * s| residual norms
    # per-pair converged-at-exit (resid <= the solver's per-pair
    # threshold): callers that solve buffer pairs beyond the requested k
    # tell "a requested pair failed" from "only a buffer pair failed"
    conv_mask: np.ndarray | None = None


def save_state(path, vectors, eigenvalues, residuals, converged) -> None:
    """Persist a Ritz panel as an .npz restart checkpoint (the JAX
    package's format: a checkpoint written by either loads in both).
    ``vectors`` should be in SAMPLE space (unpermuted)."""
    from ..utils.state import atomic_savez

    if isinstance(vectors, torch.Tensor):
        vectors = host64(vectors)
    atomic_savez(
        path,
        vectors=np.asarray(vectors, dtype=np.float64),
        eigenvalues=np.asarray(eigenvalues, dtype=np.float64),
        residuals=np.asarray(residuals, dtype=np.float64),
        converged=np.asarray(bool(converged)),
    )


def load_state(path) -> dict:
    """Load a checkpoint written by :func:`save_state`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _expand_cycle(matvec, V, gen, scale0, l, ncv, deflate_tol):
    """Lanczos steps j = l .. ncv-1.  V: (n, ncv+1), columns 0..l valid
    (column l the current unit start vector).  Returns the float64 host
    (alphas, betas); betas[j] is 0 where the step deflated.  The
    deflation floor is RELATIVE to a running ||A|| estimate seeded with
    ``scale0`` (theta_max of the previous cycle, 0 on the first)."""
    n = V.shape[0]
    alphas = np.zeros(ncv)
    betas = np.zeros(ncv)
    anorm = float(scale0)

    def orth(w):
        h1 = V.T @ w
        w = w - V @ h1
        h2 = V.T @ w
        w = w - V @ h2
        return w, h1 + h2

    for j in range(l, ncv):
        w = matvec(V[:, j])
        w, h = orth(w)
        alpha = float(h[j])
        beta = float(torch.linalg.norm(w))
        anorm = max(anorm, abs(alpha), beta)
        if beta <= deflate_tol * anorm:
            r = torch.randn(n, generator=gen, dtype=V.dtype,
                            device="cpu").to(V.device)
            r, _ = orth(r)
            vnext = r / torch.linalg.norm(r)
            beta = 0.0
        else:
            vnext = w / beta
        V[:, j + 1] = vnext
        alphas[j] = alpha
        betas[j] = beta
    return alphas, betas


def eigsh(matvec: Callable, n: int, nev: int, *, ncv: int | None = None,
          maxiter: int = 500, tol: float = 1e-6, dtype=torch.float32,
          device=None, seed: int = 1, v0: np.ndarray | None = None,
          agree=None) -> EigshResult:
    """Largest-algebraic eigenpairs of the symmetric operator ``matvec``
    (a device (n,) vector -> a device (n,) vector).  ``agree`` (a mesh's
    :meth:`Mesh.agree` across processes) gives every process rank 0's
    coefficients of each cycle, which every decision derives from."""
    if ncv is None:
        ncv = 2 * nev + 1
    ncv = min(ncv, n)
    if nev < 1:
        raise ValueError("nev must be >= 1")
    if maxiter < 1:
        raise ValueError("maxiter must be >= 1")
    if not (nev < ncv <= n):
        raise ValueError(f"need nev < ncv <= n (nev={nev}, ncv={ncv}, n={n})")

    eps = float(torch.finfo(dtype).eps)
    eps23 = eps ** (2.0 / 3.0)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.standard_normal(n)
    v0 = np.asarray(v0, dtype=np.float64)
    if v0.ndim == 2:
        # a warm-start Ritz PANEL: seed with the dominant Ritz vector
        v0 = v0[:, 0]
    v0 = v0 / np.linalg.norm(v0)

    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    V = torch.zeros((n, ncv + 1), dtype=dtype, device=device)
    V[:, 0] = torch.as_tensor(v0, device=device).to(dtype)

    nops = 0
    l = 0  # number of kept Ritz vectors after restart (0 on first cycle)
    theta_kept = np.zeros(0)
    b_coupling = np.zeros(0, dtype=np.float64)

    theta = np.zeros(nev)
    resid = np.full(nev, np.inf)
    S_keep = None
    converged = False
    restart = 0
    best_resid = np.inf
    stall = 0
    conv_mask = None

    for restart in range(maxiter):
        alphas, betas = _expand_cycle(
            matvec, V, gen,
            float(np.max(np.abs(theta_kept))) if theta_kept.size else 0.0,
            l, ncv, 10.0 * eps)
        if agree is not None:
            alphas, betas = agree(alphas, betas)
        nops += ncv - l

        # -- host: build T (arrowhead + tridiagonal), solve, test --------
        T = np.zeros((ncv, ncv), dtype=np.float64)
        if l > 0:
            T[:l, :l] = np.diag(theta_kept)
            T[:l, l] = b_coupling
            T[l, :l] = b_coupling
        T[np.arange(l, ncv), np.arange(l, ncv)] = alphas[l:]
        j = np.arange(l, ncv - 1)
        T[j, j + 1] = T[j + 1, j] = betas[l:ncv - 1]
        beta_last = betas[ncv - 1]

        theta_all, S = np.linalg.eigh(T)        # ascending
        order = np.argsort(theta_all)[::-1]     # largest algebraic first
        theta_all = theta_all[order]
        S = S[:, order]
        res_all = np.abs(beta_last * S[ncv - 1, :])

        theta = theta_all[:nev]
        resid = res_all[:nev]
        theta_max = max(abs(theta_all[0]), 1e-300)
        thresh = np.maximum(eps23 * theta_max,
                            tol * np.maximum(np.abs(theta), 1e-300))
        nconv = int(np.sum(resid <= thresh))
        # stagnation at the finite-precision floor counts as converged
        rmax = float(resid.max())
        if rmax > 0.9 * best_resid:
            stall += 1
        else:
            stall = 0
        best_resid = min(best_resid, rmax)
        at_floor = rmax <= np.sqrt(eps) * theta_max
        if (nconv >= nev or restart == maxiter - 1
                or (stall >= 8 and at_floor)):
            converged = nconv >= nev or (stall >= 8 and at_floor)
            conv_mask = resid <= thresh
            S_keep = S[:, :nev]
            break

        # -- thick restart ---------------------------------------------------
        l = min(ncv - 1, nev + max(1, (ncv - nev) // 2))
        theta_kept = theta_all[:l]
        b_coupling = beta_last * S[ncv - 1, :l]
        S_pad = np.zeros((ncv + 1, ncv + 1), dtype=np.float64)
        S_pad[:ncv, :l] = S[:, :l]
        S_pad[ncv, l] = 1.0  # residual vector becomes column l
        V = V @ torch.as_tensor(S_pad, device=V.device).to(dtype)

    S_pad = np.zeros((ncv + 1, nev), dtype=np.float64)
    S_pad[:ncv, :] = S_keep
    U = V @ torch.as_tensor(S_pad, device=V.device).to(dtype)

    return EigshResult(
        eigenvalues=theta.copy(),
        eigenvectors=U,
        n_restarts=restart + 1,
        n_ops=nops,
        converged=converged,
        residuals=resid.copy(),
        conv_mask=conv_mask.copy(),
    )
