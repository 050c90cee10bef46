"""Thick-restart BLOCK Lanczos eigensolver, subspace polish and the
compensated (two-float) Krylov refinement.

Each data pass of the packed operator applies ``X X^T`` to a b-column
panel for little more than the cost of one vector (the kernels are
bound by decode and float32 FMAs, and b columns share every decode),
so the solver builds its Krylov space panel by panel -- the
reference's matrix-operand operators anticipate this
(``perform_op_mat``, svdwide.cpp:71-118, 229-275).

Algorithm (Wu & Simon thick restart, generalized to blocks):

* Krylov basis V of ncv = m*b columns (+1 in-progress panel), built
  panel by panel: W = A Q_t; CGS2 full reorthogonalization against all
  of V (coefficients H_t = V^T A Q_t are exact column blocks of the
  projected matrix T); jittered masked-CholQR panel orthonormalization
  with a final cleanup pass (R_t = Q_{t+1}^T W feeds the residual
  estimate).
* The host assembles the small symmetric T (ncv x ncv), solves it in
  float64, tests Spectra's convergence criterion and performs the thick
  restart ``V <- V [S_kept | e_resid]``.
* Residual estimate for Ritz pair i: ``||R_last S[last b rows, i]||``;
  stagnation below sqrt(eps)*||A|| counts as converged.
* Rank-deficient panels deflate to exactly-zero columns and are
  replaced by fresh random directions with zero coupling, drawn from a
  ``torch.Generator`` seeded with ``seed``.

Under a mesh that spans processes every process runs the same solver on
replicated vectors, and ``agree`` (:meth:`Mesh.agree`) hands every one
rank 0's copy of the small host arrays each decision is taken from --
the cycle's projected blocks, the refinement's small grams, the final
residuals -- so that no process takes another branch (a product the
others do not join would hang the group).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import host64
from ..utils.trace import span, traced
from .lanczos import EigshResult, eigsh


# right-hand-side columns per triangular solve: on an H100 (PyTorch
# 2.11, CUDA 12.8) one solve_triangular of a 16 x 16 factor against
# 1,003,520 columns took 7.3 s where 501,760 took 0.2 ms, so long
# panels are solved in column blocks (each column's result is the same)
_TRSM_COLS = 1 << 18


def _solve_lower(L, B):
    """L^{-1} B for a small lower-triangular L and a wide B (b, n)."""
    return torch.cat([torch.linalg.solve_triangular(
        L, B[:, c: c + _TRSM_COLS], upper=False)
        for c in range(0, B.shape[1], _TRSM_COLS)], dim=1)


def _panel_orth(W, rank_tol, abs_floor2=0.0):
    """Rank-revealing orthonormalization: W = Q R with Q^T Q = I on the
    numerically independent directions and ZERO columns elsewhere.

    Jittered Cholesky QR of the small Gram G = W^T W (b x b):
    L = chol(G + floor I), Q = W L^{-T}.  Deficient directions surface
    as tiny pivots (L_ii^2 ~ floor) and are zeroed: after Krylov-space
    exhaustion a residual panel is cancellation noise, and normalizing
    that noise would destroy basis orthogonality.  The floor combines a
    within-panel relative tolerance (``rank_tol``) and an absolute one
    (``abs_floor2``, squared-norm scale of the panel before
    orthogonalization)."""
    b = W.shape[1]
    fi = torch.finfo(W.dtype)
    eye = torch.eye(b, dtype=W.dtype, device=W.device)

    G = W.T @ W
    # the jitter must dominate the Gram's own rounding (~eps * ||G||) or
    # the factorization of a rank-deficient panel fails; the constant
    # bottom keeps it finite on an ALL-ZERO panel
    rel = max(4.0 * b * fi.eps, float(rank_tol)) * torch.diagonal(G).max()
    floor = torch.stack([rel, torch.as_tensor(abs_floor2, dtype=W.dtype,
                                              device=W.device).reshape(()),
                         torch.as_tensor(fi.tiny * 1e6, dtype=W.dtype,
                                         device=W.device)]).max()

    # pass 1: detect deficient pivots
    L1 = torch.linalg.cholesky_ex(G + floor * eye).L
    good = (torch.diagonal(L1) ** 2 > 4.0 * floor).to(W.dtype)

    # pass 2: refactorize with deficient columns exactly zero
    W2 = W * good[None, :]
    G2 = W2.T @ W2
    L = torch.linalg.cholesky_ex(G2 + floor * eye).L
    Q = _solve_lower(L, W2.T).T * good[None, :]
    nq = torch.linalg.norm(Q, dim=0)
    Q = Q / torch.where(nq > 0, nq, torch.ones_like(nq))[None, :]
    # R as the exact projection of the ORIGINAL panel onto the final
    # basis (linearly dependent deficient columns still carry coupling)
    R = Q.T @ W
    return Q, R, good


def _orth2(V, W):
    H1 = V.T @ W
    W = W - V @ H1
    H2 = V.T @ W
    W = W - V @ H2
    return W, H1 + H2


def _proj_out(B, X):
    return X - B @ (B.T @ X)


def _expand_cycle(matvec, V, gen, l, nsteps, b, jitter):
    """Expand panels t = 0..nsteps-1 starting at column l, in place in
    V.  Returns the device stacks H (nsteps, ncv+b, b), R (nsteps, b, b)."""
    n = V.shape[0]
    Hs, Rs = [], []
    for t in range(nsteps):
        with span("lanczos/step"):
            cs = l + t * b
            W = matvec(V[:, cs: cs + b])
            scale2 = (W * W).sum() / b        # pre-orth mean sq col norm
            Wo, H = _orth2(V, W)
            Q1, _, _ = _panel_orth(Wo, jitter, jitter * scale2)
            # normalizing near-deflated directions amplifies their
            # residual overlap with V by 1/norm -- clean with another
            # CGS pass
            Q1 = _proj_out(V, Q1)
            Qn, _, good = _panel_orth(Q1, jitter)
            if not bool(good.all()):
                # deflation: replace zeroed directions with FRESH random
                # ones orthogonal to everything (zero coupling); if the
                # space is exhausted the fresh panel cancels below its
                # floor
                Z = torch.randn((n, b), generator=gen, dtype=V.dtype,
                                device="cpu").to(V.device)
                z2 = (Z * Z).sum() / b
                Z, _ = _orth2(V, Z)
                Z = _proj_out(Qn, Z)
                Zq, _, _ = _panel_orth(Z, jitter, jitter * z2)
                Qn = torch.where(good[None, :] > 0, Qn, Zq)
            # final cleanup: one more V-projection + panel pass brings
            # both V-orthogonality and within-panel orthonormality down
            # to ~eps
            Qn = _proj_out(V, Qn)
            Qn, _, _ = _panel_orth(Qn, jitter)
            # exact coupling of A Q_t onto the FINAL panel
            R = Qn.T @ Wo
            V[:, cs + b: cs + 2 * b] = Qn
            Hs.append(H)
            Rs.append(R)
    return torch.stack(Hs), torch.stack(Rs)


def _colnorm1(Y):
    """Scale columns to unit norm (zero columns stay zero): keeps the
    column space and makes CholQR's rank test scale-free per column."""
    nrm = torch.linalg.norm(Y, dim=0)
    return Y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]


def _same(*arrays):
    return arrays if len(arrays) != 1 else arrays[0]


def _ff_resid_panel(U, y_hi, y_lo, agree=_same):
    """Well-conditioned orthonormal panel spanning A U - U (U^T A U).

    CGS2 against U in float32 (direction accuracy ~1e-3 is plenty), then
    a COMPENSATED Gram + host-float64 eigendecomposition with rank
    truncation: kept directions have Gram eigenvalues > 1e-4 * max,
    which bounds the mixing coefficients and the final metric's
    conditioning."""
    from ..ops.compensated import gram_small_ff

    Y = y_hi + y_lo
    R = Y - U @ (U.T @ Y)
    R = _colnorm1(R)
    R = R - U @ (U.T @ R)
    R = _colnorm1(R)
    with span("polish/ritz"):
        G = agree(gram_small_ff(R))             # float64 host, ff-accurate
        lam, V = np.linalg.eigh(G)
    keep = lam > 1e-4 * max(lam[-1], 1e-30)
    if not keep.any():
        return R[:, :0]
    T = V[:, keep] / np.sqrt(lam[keep])[None, :]
    return R @ torch.as_tensor(T, device=R.device).to(R.dtype)


def _ritz_generalized(H, M):
    """Solve the small generalized Rayleigh-Ritz problem H S = M S Theta;
    when M is not positive definite (a dependent column slipped past the
    residual-panel truncation) fall back to whitening.  Either path
    returns S with S^T M S = I on the kept subspace."""
    from scipy.linalg import LinAlgError
    from scipy.linalg import eigh as _geigh

    try:
        return _geigh(H, M)
    except LinAlgError:
        return _ritz_whitened(H, M)


def _ritz_whitened(H, M):
    """Rank-truncated whitening solve of H S = M S Theta."""
    lam_m, V_m = np.linalg.eigh(M)
    keep = lam_m > 1e-10 * max(lam_m[-1], 1e-30)
    W = V_m[:, keep] / np.sqrt(lam_m[keep])[None, :]
    theta, S_w = np.linalg.eigh(W.T @ H @ W)
    return theta, W @ S_w


@traced("polish/refine")
def _ff_krylov_refine(ff_gram, U, k, rounds: int = 1,
                      return_resid: bool = False, agree=_same):
    """Block-Krylov refinement over the COMPENSATED operator.

    Each round takes ONE compensated data pass on the current residual
    panel, keeps it as a basis block, and re-solves the small
    Rayleigh-Ritz problem with an ff-accurate projected matrix H and
    metric M (generalized: float32 CGS cannot make the basis
    orthonormal beyond ~1e3*eps)."""
    from ..ops.compensated import gram_small_ff, ritz_ff

    y_hi, y_lo = ff_gram(U)
    B, Yh, Yl = U, y_hi, y_lo
    theta = None
    for _ in range(rounds):
        R = _ff_resid_panel(U, y_hi, y_lo, agree)
        if R.shape[1]:
            rh, rl = ff_gram(R)
            B = torch.cat([B, R], dim=1)
            Yh = torch.cat([Yh, rh], dim=1)
            Yl = torch.cat([Yl, rl], dim=1)
        with span("polish/ritz"):
            H = ritz_ff(B, Yh, Yl)
            H, M = agree(0.5 * (H + H.T), gram_small_ff(B))
            theta, S = _ritz_generalized(H, M)
        order = np.argsort(theta)[::-1][:k]
        theta = theta[order]
        S = torch.as_tensor(np.ascontiguousarray(S[:, order]),
                            device=U.device).to(U.dtype)
        # U and A U for the next residual panel without a data pass
        U, y_hi, y_lo = B @ S, Yh @ S, Yl @ S
    if return_resid:
        th = torch.as_tensor(theta, device=U.device).to(U.dtype)
        r = (y_hi - U * th[None, :]) + y_lo
        resid = agree(host64(torch.sqrt((r * r).sum(dim=0))))
        return theta, U, resid
    return theta, U


def polish_subspace(matvec, U, *, iters: int = 2, ff_gram=None,
                    return_resid=False, agree=None):
    """Refine converged Ritz vectors by orthogonal (subspace) iteration
    with a final host-float64 Rayleigh-Ritz.  Returns (theta, U) with
    theta descending.

    ``ff_gram`` (optional): an operator's compensated two-float gram
    (``gram_ff_permuted``).  When given, the final step becomes a
    Rayleigh-Ritz over the augmented basis [U | orth(A U - U (U^T A U))]
    with the products and the projected matrix in two-float precision:
    float32 products carry ~1e3*eps accumulation noise, and the true
    residual directions are the same size as that noise, so no float32
    product can see them.  Sequence: refine -> float32 sweep -> refine
    (the sweep pulls the surviving full-spectrum error to the top of the
    spectrum, where the second refinement's residual panel sees it)."""
    k = U.shape[1]
    rank_tol = (100 * float(torch.finfo(U.dtype).eps)) ** 2
    agree = agree or _same

    def sweep(U):
        with span("polish/sweep"):
            Y = _colnorm1(matvec(U))
            Q, _, _ = _panel_orth(Y, rank_tol)
            Q, _, _ = _panel_orth(Q, rank_tol)
            return Q

    for _ in range(iters):
        U = sweep(U)
    if ff_gram is not None:
        _, U = _ff_krylov_refine(ff_gram, U, k, rounds=1, agree=agree)
        U = sweep(U)
        return _ff_krylov_refine(ff_gram, U, k, rounds=1,
                                 return_resid=return_resid, agree=agree)
    with span("polish/ritz"):
        Y = matvec(U)
        G = agree(host64(U.T @ Y))
        G = 0.5 * (G + G.T)
        theta, S = np.linalg.eigh(G)
        order = np.argsort(theta)[::-1][:k]
        theta = theta[order]
        S = np.ascontiguousarray(S[:, order])
        U = U @ torch.as_tensor(S, device=U.device).to(U.dtype)
    return theta, U


def _cycle_ritz(H, R, theta_kept, l, nsteps, ncv, b):
    """A cycle's host Rayleigh-Ritz: the symmetric T (ncv x ncv) from the
    kept Ritz values and the cycle's projected blocks ``H``, its
    eigenpairs descending, and each pair's residual estimate from the
    last panel's coupling ``R``."""
    T = np.zeros((ncv, ncv), dtype=np.float64)
    if l > 0:
        T[:l, :l] = np.diag(theta_kept)
    for t in range(nsteps):
        cs = l + t * b
        T[: cs + b, cs: cs + b] = H[t, : cs + b]
        D = T[cs: cs + b, cs: cs + b]
        T[cs: cs + b, cs: cs + b] = 0.5 * (D + D.T)
        T[cs: cs + b, : cs] = T[: cs, cs: cs + b].T
    theta_all, S = np.linalg.eigh(T)
    order = np.argsort(theta_all)[::-1]
    S = S[:, order]
    res_all = np.linalg.norm(R[nsteps - 1] @ S[ncv - b:, :], axis=0)
    return theta_all[order], S, res_all


def _start_basis(n, cols, b, seed, v0, dtype, device):
    """The (n, cols) Krylov basis, its first panel the QR of a seeded
    random (n, b) draw whose leading columns ``v0`` replaces.

    The draw is the host's (numpy ``default_rng(seed)``, the JAX
    package's start panel); its Householder QR runs in float64 on the
    device that holds the basis, where a 501,760 x 16 panel takes
    milliseconds and one host thread ~1 s."""
    with span("lanczos/draw"):
        rng = np.random.default_rng(seed)
        Q0 = rng.standard_normal((n, b))
        if v0 is not None:
            # warm start: a vector seeds the first column; an (n, j)
            # panel (e.g. Ritz vectors from a restart checkpoint) up to
            # b columns
            v0 = np.asarray(v0, dtype=np.float64)
            if v0.ndim == 1:
                Q0[:, 0] = v0
            else:
                j = min(b, v0.shape[1])
                Q0[:, :j] = v0[:, :j]
        Q0 = torch.as_tensor(Q0, device=device)
    with span("lanczos/orth"):
        V = torch.zeros((n, cols), dtype=dtype, device=device)
        V[:, :b] = torch.linalg.qr(Q0).Q
    return V


@traced("lanczos/solve")
def eigsh_block(matvec, n: int, nev: int, *, block: int = 16,
                ncv: int | None = None, maxiter: int = 500,
                tol: float = 1e-6, dtype=torch.float32, device=None,
                seed: int = 1, v0: np.ndarray | None = None,
                verbose: bool = False, checkpoint_every: int = 0,
                checkpoint_fn=None, agree=None) -> EigshResult:
    """Largest-algebraic eigenpairs via thick-restart block Lanczos.

    ``matvec`` maps an (n, b) device panel to an (n, b) device panel.
    Falls back to the scalar solver when the problem is too small for
    blocking.  ``conv_mask`` in the result tells callers that solve
    buffer pairs beyond the dimensions they return WHICH pairs met
    tolerance.

    ``checkpoint_every=R`` (with a ``checkpoint_fn``) calls
    ``checkpoint_fn(panel, values, residuals)`` after every R-th thick
    restart with the current top Ritz panel (a device tensor of up to
    one solver panel of columns, what a ``v0`` warm start takes): the
    solve survives the death of its process.  The scalar fallback takes
    no mid-run checkpoints and warns when they were asked for.
    ``agree``: see the module docstring (one broadcast a cycle)."""
    if maxiter < 1:
        raise ValueError("maxiter must be >= 1")
    b = int(block)
    if ncv is not None:
        cc = ncv
    else:
        # ~4*nev rounded up to whole panels (the JAX package's rule for
        # structured genotype spectra, chosen by data-pass count); the
        # max() keeps a panel of post-restart headroom for small nev
        cc = max(4 * nev, nev + 2 * b)
        cc = b * (-(-cc // b))
        cc = min(cc, b * ((n - b) // b))
    ncv = b * (cc // b) if cc % b else cc
    # require a full panel of headroom beyond the basis (ncv + 2b <= n)
    if ncv + 2 * b > n or nev + b > ncv or b < 2:
        if checkpoint_fn is not None and checkpoint_every > 0:
            import warnings

            warnings.warn(
                "problem too small for the block solver; falling back to "
                "scalar Lanczos, which does NOT take mid-run checkpoints "
                "(checkpoint_every ignored; the end-of-solve state write "
                "still happens)", RuntimeWarning, stacklevel=2)
        return eigsh(lambda x: matvec(x[:, None])[:, 0], n, nev,
                     maxiter=maxiter, tol=tol, dtype=dtype, device=device,
                     seed=seed, v0=v0, agree=agree)

    eps = float(torch.finfo(dtype).eps)
    eps23 = eps ** (2.0 / 3.0)
    # absolute deflation floor scale for _panel_orth (squared-norm
    # units, multiplied by each panel's pre-orthogonalization scale)
    jitter = (100 * eps) ** 2

    with span("lanczos/start"):
        V = _start_basis(n, ncv + b, b, seed, v0, dtype, device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    nops = 0
    l = 0
    theta_kept = np.zeros(0)
    theta = np.zeros(nev)
    resid = np.full(nev, np.inf)
    S_keep = None
    converged = False
    conv_mask = None
    restart = 0
    best_resid = np.inf
    stall = 0

    for restart in range(maxiter):
        with span("lanczos/cycle"):
            nsteps = (ncv - l) // b
            H, R = _expand_cycle(matvec, V, gen, l, nsteps, b, jitter)
            nops += nsteps
            with span("lanczos/ritz"):
                H, R = (agree or _same)(host64(H), host64(R))
                theta_all, S, res_all = _cycle_ritz(H, R, theta_kept, l,
                                                    nsteps, ncv, b)
                theta = theta_all[:nev]
                resid = res_all[:nev]
                # Spectra-style per-pair tolerance with the roundoff
                # floor scaled by ||A|| ~= theta_max
                theta_max = max(abs(theta_all[0]), 1e-300)
                thresh = np.maximum(eps23 * theta_max,
                                    tol * np.maximum(np.abs(theta), 1e-300))
                nconv = int(np.sum(resid <= thresh))
                if verbose:
                    import sys
                    print(f"eigsh_block cycle {restart}: nconv={nconv}/"
                          f"{nev} max_resid={resid.max():.3e} "
                          f"theta_max={theta_max:.4e}",
                          file=sys.stderr, flush=True)
                # stagnation acceptance: residuals stopped improving
                # below sqrt(eps) * ||A||, the finite-precision floor of
                # clustered spectra
                rmax = float(resid.max())
                if rmax > 0.9 * best_resid:
                    stall += 1
                else:
                    stall = 0
                best_resid = min(best_resid, rmax)
                at_floor = rmax <= np.sqrt(eps) * theta_max
                if (nconv >= nev or restart == maxiter - 1
                        or (stall >= 5 and at_floor)):
                    converged = nconv >= nev or (stall >= 5 and at_floor)
                    conv_mask = resid <= thresh
                    S_keep = S[:, :nev]
                    break

                # -- thick restart -------------------------------------
                l = b * min(ncv // b - 1,
                            max(1, -(-(nev + (ncv - nev) // 2) // b)))
                theta_kept = theta_all[:l]
                S_pad = np.zeros((ncv + b, ncv + b), dtype=np.float64)
                S_pad[:ncv, :l] = S[:, :l]
                S_pad[ncv:, l: l + b] = np.eye(b)   # residual panel -> l
                V = V @ torch.as_tensor(S_pad, device=V.device).to(dtype)

                # after the rotation V[:, :l] ARE the kept Ritz vectors
                # (theta_kept, descending): a checkpoint costs no device
                # work
                if (checkpoint_fn is not None and checkpoint_every > 0
                        and (restart + 1) % checkpoint_every == 0):
                    m = min(l, b)   # a v0 warm start seeds one panel
                    checkpoint_fn(V[:, :m], theta_kept[:m].copy(),
                                  res_all[:m].copy())

    with span("lanczos/ritz"):
        S_pad = np.zeros((ncv + b, S_keep.shape[1]), dtype=np.float64)
        S_pad[:ncv] = S_keep
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
