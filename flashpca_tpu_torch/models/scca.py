"""Sparse canonical correlation analysis (SCCA).

Equivalent of ``RandomPCA::scca`` (reference: randompca.cpp:225-528):
penalized alternating power iteration on X^T Y with sequential
Gram-Schmidt deflation.  Per dimension j:

* ``u <- X^T (Y v)``; orthogonalize against U[:, :j]; ``norm_thresh(u, l1)``
* ``v <- Y^T (X u)``; orthogonalize against V[:, :j]; ``norm_thresh(v, l2)``
* converged when ``max|du| < tol`` and ``max|dv| < tol``
* ``d[j] = (X u_j)^T (Y v_j)``

``norm_thresh(x, l)``: normalize, soft-threshold by l, renormalize
(randompca.cpp:233-245).  With ``divisor='n1'`` both sides carry a
``1/sqrt(n-1)`` factor (``invdiv`` on the X-side products,
randompca.cpp:404-409).

The X-side products are the packed operator's ``crossprod`` (kernel B1
on a float32 CUDA operator) and ``prod`` (B2); on a float64 operator the
functional core, on a :class:`DenseOperator` ``torch.matmul``.  Two
engines drive the iteration:

* the device engine (:func:`_scca_dim_device_grid`) keeps the whole
  iteration on the operator's device in its dtype, with one host sync
  per iteration (the loop's test) and one transfer per dimension; a
  solo run is its one-cell case, and :func:`scca_grid` runs C penalty
  cells through ONE C-column panel pass per product;
* the host engine (:func:`_scca_dim_host_grid`, its twin) keeps U/V
  and the thresholding on the host in float64, one C-column operator
  product per step; a solo run is again its one-cell case, with the
  JAX package's solo host loop's semantics on a failed run (``solo``).
  It is the only engine a :class:`StreamingPackedOperator` runs.

Under a mesh that spans processes (parallel/dist.py) every process runs
the same iteration on replicated vectors; each step's continue test and
each dimension's outcome come from rank 0 (:meth:`Mesh.agree`), so that
no process runs a product the others skip, and only rank 0 writes the
checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.plink import PlinkDataset
from ..ops.operator import (TALL_OPERATORS, WIDE_OPERATORS, DenseOperator,
                            StreamingPackedOperator, build_packed_operator,
                            check_operator_conflicts)
from ..ops.standardize import standardize
from ..utils.device import default_dtype, host64, resolve_device
from ..parallel.dist import agree_fn, barrier, writer
from ..utils.logging import log
from ..utils.trace import span, traced
from ._common import note_unsharded


@dataclass
class SCCAResult:
    U: np.ndarray          # (p, ndim) X-side weights
    V: np.ndarray          # (k, ndim) Y-side weights
    d: np.ndarray          # (ndim,) canonical covariances
    Px: np.ndarray         # (N, ndim) = X U (scaled)
    Py: np.ndarray         # (N, ndim) = Y V
    converged: bool
    V0: np.ndarray         # the initial V (for reproducibility, --save-vinit)
    # (ndim,) u/v updates run per dimension (0 where none ran in this
    # call: not reached, or restored from state_in); not in the JAX
    # package's result
    n_iters: np.ndarray | None = None

    def __repr__(self):
        return f"SCCAResult(ndim={len(self.d)}, converged={self.converged})"


def soft_thresh(a: np.ndarray, b: float) -> np.ndarray:
    """sign(a) * max(|a| - b, 0) (randompca.cpp:225-231)."""
    return np.sign(a) * np.maximum(np.abs(a) - b, 0.0)


def norm_thresh(x: np.ndarray, lam: float) -> np.ndarray:
    """Normalize, soft-threshold by ``lam``, renormalize
    (randompca.cpp:233-245); a zero vector stays zero."""
    s = np.linalg.norm(x)
    if s > 0:
        x = x / s
        x = soft_thresh(x, lam)
        s = np.linalg.norm(x)
        if s > 0:
            x = x / s
    return x


def make_gaussian(rows: int, cols: int, seed: int) -> np.ndarray:
    """Seeded standard-normal init matrix (randompca.cpp:16-27): numpy's
    PCG64, so that a seed gives the same V0 as the JAX package (the
    reference's boost mt19937 draws other values)."""
    return np.random.default_rng(seed).standard_normal((rows, cols))


def save_scca_state(path, U, V, d, next_dim, V0,
                    lambda1, lambda2, *, divisor=None, stand_x=None,
                    stand_y=None) -> None:
    """Persist SCCA progress after a completed dimension (atomic .npz,
    the JAX package's keys and dtypes).  The deflation is sequential
    (randompca.cpp:428-498), so the finished columns U[:, :next_dim] /
    V / d and the shared V0 are the whole resume state; the penalties,
    divisor and standardizations ride along so that a resume under
    other settings is refused."""
    from ..utils.state import atomic_savez

    extra = {}
    if divisor is not None:
        extra["divisor"] = np.asarray(str(divisor))
    if stand_x is not None:
        extra["stand_x"] = np.asarray(str(stand_x))
    if stand_y is not None:
        extra["stand_y"] = np.asarray(str(stand_y))
    atomic_savez(
        path,
        U=np.asarray(U, dtype=np.float64),
        V=np.asarray(V, dtype=np.float64),
        d=np.asarray(d, dtype=np.float64),
        next_dim=np.asarray(int(next_dim)),
        V0=np.asarray(V0, dtype=np.float64),
        lambda1=np.asarray(float(lambda1)),
        lambda2=np.asarray(float(lambda2)),
        **extra,
    )


def load_scca_state(path) -> dict:
    """Load a checkpoint written by :func:`save_scca_state` (of either
    package)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _gram_schmidt(vec: np.ndarray, basis: np.ndarray, j: int) -> np.ndarray:
    """Orthogonalize vec against basis[:, :j], one column at a time with
    per-column normalization (randompca.cpp:270-278 order preserved)."""
    for k in range(j):
        col = basis[:, k]
        denom = col @ col
        if denom > 0:
            vec = vec - (vec @ col) * col / denom
    return vec


# ---------------------------------------------------------------------------
# The device engine: one dimension's iteration on the operator's device
# ---------------------------------------------------------------------------

def _gs_cells(x, basis, j):
    """Orthogonalize each cell's column x[:, c] against basis[:, :j, c],
    one column at a time (reference order, randompca.cpp:270-278); a
    zero basis column (a frozen cell's) is skipped."""
    for t in range(j):
        col = basis[:, t, :]
        denom = (col * col).sum(dim=0)
        num = (x * col).sum(dim=0)
        pos = denom > 0
        proj = torch.where(pos, num / torch.where(pos, denom, 1.0), 0.0)
        x = x - proj[None, :] * col
    return x


def _norm_thresh_cells(x, lam):
    """Per-cell normalize -> soft-threshold -> renormalize; zero columns
    stay zero (no division by a zero norm)."""
    s = torch.linalg.vector_norm(x, dim=0)
    x = torch.where(s > 0, x / torch.where(s > 0, s, 1.0)[None, :], x)
    x = torch.sign(x) * torch.clamp(x.abs() - lam[None, :], min=0.0)
    s2 = torch.linalg.vector_norm(x, dim=0)
    return torch.where(s2 > 0, x / torch.where(s2 > 0, s2, 1.0)[None, :], x)


def _scca_dim_device_grid(op, U, V, Yp, j, v0, alive, lam1, lam2, invdiv,
                          tol, maxiter):
    """One SCCA dimension for ALL penalty-grid cells at once, on the
    operator's device in its dtype.

    The genotype products do not depend on the penalties, so the C cells
    stack into the panel of ONE ``op._cross_p`` (X^T x on a permuted
    panel, its input masked to the valid samples) / ``op._mv_p`` (X v in
    permuted space, its byte-padding rows zero) pass per step (B1 and B2
    at a C-column panel on a float32 CUDA operator; neither counts in
    ``nops``): a grid costs about max-over-cells iterations of passes,
    not their sum.  A solo ``scca(engine='device')`` run is the C = 1
    case.

    ``U`` (p, ndim, C) / ``V`` (k, ndim, C) are the per-cell deflation
    histories (column j is written in place), ``Yp`` (n4, k) the scaled
    Y in the operator's permuted sample space, ``v0`` (k, C) the start,
    ``alive`` (C,) masks cells whose earlier dimension failed: their
    state stays frozen, so the surviving cells compute what a solo run
    computes.  ``lam1``/``lam2`` (C,) and ``invdiv``/``tol`` are tensors
    of the operator's dtype.

    The loop's test costs one host sync per iteration; no p-long vector
    leaves the device inside the loop.  Returns ``(U, V, packed)`` with
    ``packed`` ONE (p + k + 5, C) host float64 array stacking u, v and
    the per-cell [iters, conv, u_zero, v_zero, d] (:func:`_unpack_dim`):
    one device-to-host transfer per dimension."""
    dtype = Yp.dtype

    def u_step(v):
        u = op._cross_p(Yp @ v) * invdiv                # ONE panel pass
        return _norm_thresh_cells(_gs_cells(u, U, j), lam1)

    def v_step(u):
        xu = op._mv_p(u) * invdiv                       # ONE panel pass
        return _norm_thresh_cells(_gs_cells(Yp.T @ xu, V, j), lam2)

    C = v0.shape[1]
    agree = agree_fn(op)
    u = torch.zeros((U.shape[0], C), dtype=dtype, device=Yp.device)
    v = v0.clone()
    it = torch.zeros(C, dtype=torch.int64, device=Yp.device)
    du = torch.full((C,), float("inf"), dtype=dtype, device=Yp.device)
    dv = du.clone()
    uz = torch.zeros(C, dtype=torch.bool, device=Yp.device)
    vz = uz.clone()

    def active():
        act = alive & (it < maxiter) & ((it == 0) | (du >= tol) | (dv >= tol))
        act = act & ~(uz | vz) if j == 0 else act
        if agree is not None:
            act = torch.as_tensor(agree(act.cpu().numpy()), device=act.device)
        return act

    act = active()
    more = bool(act.any())
    while more:
        with span("scca/iter"):
            u_new = u_step(v)
            uzi = u_new.abs().amax(dim=0) < tol        # u zeroed THIS iter
            v_new = v_step(u_new)
            du_new = (u_new - u).abs().amax(dim=0)
            dv_new = (v_new - v).abs().amax(dim=0)
            uz_new = uz | uzi
            vz_new = vz | (v_new.abs().amax(dim=0) < tol)
            # frozen (converged/dead) cells keep their state; a dim-0
            # u-zero abort also keeps v at its pre-step value (V0): the
            # reference aborts BEFORE the v step (randompca.cpp:280-287)
            keep_v = act & ~uzi if j == 0 else act
            u = torch.where(act, u_new, u)
            v = torch.where(keep_v, v_new, v)
            du = torch.where(act, du_new, du)
            dv = torch.where(keep_v, dv_new, dv)
            uz = torch.where(act, uz_new, uz)
            vz = torch.where(keep_v, vz_new, vz)
            it = it + act.to(torch.int64)
            act = active()
            more = bool(act.any())

    with span("scca/dim_end"):
        conv = (du < tol) & (dv < tol)
        # d_c = (X u_c)^T (Y v_c), both sides invdiv-scaled (one panel
        # pass); both factors are zero on the byte-padding rows
        xu = op._mv_p(u) * invdiv
        d = (xu * (Yp @ v)).sum(dim=0)
        U[:, j, :] = u
        V[:, j, :] = v
        scalars = torch.stack([it.to(dtype), conv.to(dtype), uz.to(dtype),
                               vz.to(dtype), d])
        packed = host64(torch.cat([u, v, scalars], dim=0))
        if agree is not None:
            packed = agree(packed)
    return U, V, packed


def _unpack_dim(packed, p, k):
    """Split the device engine's per-dimension transfer into per-cell
    host arrays ``(u, v, iters, conv, u_zero, v_zero, d)``."""
    u = packed[:p]
    v = packed[p:p + k]
    it = packed[p + k].astype(np.int64)
    conv = packed[p + k + 1] > 0
    uz = packed[p + k + 2] > 0
    vz = packed[p + k + 3] > 0
    d = packed[p + k + 4]
    return u, v, it, conv, uz, vz, d


class _DeviceGrid:
    """The device engine's state for one operator: its products, Y in
    permuted space and the per-cell histories, on the operator's device
    in its dtype."""

    def __init__(self, op, Y_std, U, V, lam1_c, lam2_c, invdiv, tol):
        self.op = op
        t = dict(dtype=op.dtype, device=op.device)
        self.Yp = op.permute(Y_std)
        # copies: the engine writes column j of its histories in place
        self.U = torch.tensor(U, **t)
        self.V = torch.tensor(V, **t)
        self.lam1 = torch.as_tensor(lam1_c, **t)
        self.lam2 = torch.as_tensor(lam2_c, **t)
        self.invdiv = torch.tensor(invdiv, **t)
        self.tol = torch.tensor(tol, **t)
        self.t = t

    @traced("scca/dim")
    def dim(self, j, v0, alive, maxiter):
        """One dimension for every cell; ``v0`` (k, C) and ``alive``
        (C,) on the host.  Returns :func:`_unpack_dim`'s tuple."""
        self.U, self.V, packed = _scca_dim_device_grid(
            self.op, self.U, self.V, self.Yp, j,
            torch.tensor(np.asarray(v0), **self.t),
            torch.as_tensor(np.asarray(alive), device=self.t["device"]),
            self.lam1, self.lam2, self.invdiv, self.tol, maxiter)
        return _unpack_dim(packed, self.U.shape[0], self.V.shape[0])


# ---------------------------------------------------------------------------
# The host grid engine (the streaming operator's)
# ---------------------------------------------------------------------------

def _scca_dim_host_grid(op, U, V, Y_std, j, v0, alive, lam1, lam2,
                        invdiv, tol, maxiter, solo=False):
    """One SCCA dimension for ALL penalty-grid cells, driven from the
    host: the batched twin of :func:`_scca_dim_device_grid` for
    streaming operators, whose products stage host blocks.

    Each iteration's ``X^T (Y v)`` / ``X u`` run as ONE C-column panel
    through the operator in its dtype, so all C cells share every staged
    pass (the staging cost does not depend on the panel width).  Per-cell
    math mirrors the device engine cell for cell (deflation order,
    norm_thresh, zero and convergence tests, frozen-cell masking) in
    float64 host arithmetic.  ``U`` (p, ndim, C) / ``V`` (k, ndim, C)
    are the float64 histories (read only); returns ``(u, v, it, conv,
    uz, vz, d)`` per cell, as :func:`_unpack_dim`.

    ``solo`` gives a solo ``scca(engine='host')`` run the JAX package's
    solo host loop where it differs from the grid engines: it takes at
    least two steps before it tests convergence, and a dimension-0 abort
    keeps the vector of the step before in place of the one that was
    zeroed (u and v when u is zeroed, v when v is)."""
    p, C = U.shape[0], v0.shape[1]
    agree = agree_fn(op) or (lambda *a: a if len(a) != 1 else a[0])

    def gs(x, basis):
        for t in range(j):
            col = basis[:, t, :]
            denom = np.einsum("mc,mc->c", col, col)
            num = np.einsum("mc,mc->c", x, col)
            proj = np.where(denom > 0,
                            num / np.where(denom > 0, denom, 1.0), 0.0)
            x = x - proj[None, :] * col
        return x

    def nthresh(x, lam):
        s = np.linalg.norm(x, axis=0)
        x = np.where(s > 0, x / np.where(s > 0, s, 1.0)[None, :], x)
        x = np.sign(x) * np.maximum(np.abs(x) - lam[None, :], 0.0)
        s2 = np.linalg.norm(x, axis=0)
        return np.where(s2 > 0, x / np.where(s2 > 0, s2, 1.0)[None, :], x)

    def cross_panel(yn):   # (n, C) -> (p, C), ONE staged pass
        return host64(op.crossprod(yn)) * invdiv

    def prod_panel(up):    # (p, C) -> (n, C), ONE staged pass
        return host64(op.prod(up)) * invdiv

    u = np.zeros((p, C), dtype=np.float64)
    v = np.asarray(v0, dtype=np.float64).copy()
    it = np.zeros(C, dtype=np.int64)
    du = np.full(C, np.inf)
    dv = np.full(C, np.inf)
    uz = np.zeros(C, dtype=bool)
    vz = np.zeros(C, dtype=bool)

    first = 2 if solo else 1     # steps taken before the first test

    def active():
        act = (alive & (it < maxiter)
               & ((it < first) | (du >= tol) | (dv >= tol)))
        return agree(act & ~((j == 0) & (uz | vz)))

    act = active()
    while act.any():
        u_new = nthresh(gs(cross_panel(Y_std @ v), U), lam1)
        uzi = np.max(np.abs(u_new), axis=0) < tol     # u zeroed THIS iter
        v_new = nthresh(gs(Y_std.T @ prod_panel(u_new), V), lam2)
        vzi = np.max(np.abs(v_new), axis=0) < tol
        du_new = np.max(np.abs(u_new - u), axis=0)
        dv_new = np.max(np.abs(v_new - v), axis=0)
        # a dim-0 u-zero abort stops before the v step
        stepped_v = act & ~((j == 0) & uzi)
        set_u, set_v = act, stepped_v
        if solo and j == 0:
            set_u, set_v = act & ~uzi, stepped_v & ~vzi
        u = np.where(set_u, u_new, u)
        v = np.where(set_v, v_new, v)
        du = np.where(act, du_new, du)
        dv = np.where(stepped_v, dv_new, dv)
        uz = np.where(act, uz | uzi, uz)
        vz = np.where(stepped_v, vz | vzi, vz)
        it = it + act.astype(np.int64)
        act = active()

    conv = (du < tol) & (dv < tol)
    # d is read only where a cell converged: no staged pass otherwise
    d = (np.einsum("nc,nc->c", prod_panel(u), Y_std @ v) if conv.any()
         else np.zeros(C))
    return agree(u, v, it, conv, uz, vz, d)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _xside_operator(X, n, k, ndim, stand_x, *, streaming, memory_mb,
                    block_size, dtype, device, mesh, who="scca"):
    """Resolve the X side of an SCCA problem to a wide operator: a PLINK
    root or dataset (the packed operator, streamed under ``streaming`` /
    ``memory_mb``), a numeric (N, p) matrix (standardized on the host in
    float64 and held by a :class:`DenseOperator` in ``dtype``, by
    default the device's), or a prebuilt wide operator (its keyword
    conflicts checked).  The ndim cap is checked before any genotype is
    read (scca.R:210-215).  ``mesh`` shards the packed operator; the
    dense path runs unsharded and says so."""
    if isinstance(X, str):
        X = PlinkDataset.open(X)
    if isinstance(X, TALL_OPERATORS):
        raise ValueError(
            f"{who}() needs the wide product layout (X^T y crossprod and "
            "X u prod); pass the PLINK data (or a wide operator) instead "
            "of a tall operator")
    prebuilt = isinstance(X, WIDE_OPERATORS)
    if (not prebuilt and not isinstance(X, PlinkDataset)
            and hasattr(X, "crossprod")):
        raise TypeError(
            f"{who}() got a {type(X).__module__}.{type(X).__name__}, "
            "which is not an operator of this package; build a "
            "flashpca_tpu_torch operator (e.g. DenseOperator) instead")
    # more canonical dimensions than the spaces support cannot converge
    # (deflation exhausts the Y side)
    p = (X.n_snps if prebuilt or isinstance(X, PlinkDataset)
         else np.shape(X)[1])
    max_dim = min(p, n, k)
    if ndim > max_dim:
        raise ValueError(
            f"You asked for {ndim} dimensions, but only {max_dim} allowed")
    if prebuilt:
        check_operator_conflicts(X, dtype=dtype, streaming=streaming,
                                 memory_mb=memory_mb, block_size=block_size,
                                 device=device, mesh=mesh)
        if X.n_samples != n:
            raise ValueError("Y rows must equal the number of samples")
        return X
    if isinstance(X, PlinkDataset):
        if X.n_samples != n:
            raise ValueError("Y rows must equal the number of samples")
        mean, sd = X.snp_stats(stand_x)
        return build_packed_operator(
            X, mean, sd, streaming=streaming, memory_mb=memory_mb,
            block_size=block_size, dtype=dtype, device=device, mesh=mesh)
    # a numeric matrix: there is no streaming dense operator, so an
    # explicit bounded-memory request cannot be honored
    if streaming is True or memory_mb is not None:
        raise ValueError(
            "streaming=True / memory_mb apply to PLINK (packed) X data; "
            "a dense matrix X is held in device memory whole -- pass the "
            "PLINK fileset (or a StreamingPackedOperator) for bounded "
            "device memory"
        )
    dev = resolve_device(device)
    note_unsharded(mesh, "SCCA")
    Xm = np.asarray(X, dtype=np.float64)
    if Xm.shape[0] != n:
        raise ValueError("Y rows must equal the number of samples")
    X_std, _, _ = standardize(Xm, stand_x)
    return DenseOperator(torch.from_numpy(X_std), device=dev,
                         dtype=dtype or default_dtype(dev))


def _scaled_y(Y, stand_y, divisor):
    """Y standardized and scaled by invdiv; returns (Y_std, invdiv)."""
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    Y_std, _, _ = standardize(Y, stand_y)
    invdiv = 1.0
    if divisor == "n1":
        invdiv = 1.0 / np.sqrt(Y_std.shape[0] - 1.0)
    return Y_std * invdiv, invdiv


def _v0_of(V0, k, ndim, seed):
    if V0 is None:
        return make_gaussian(k, ndim, seed)
    V0 = np.asarray(V0, dtype=np.float64)
    if V0.shape != (k, ndim):
        raise ValueError(f"V0 must be ({k}, {ndim})")
    return V0


@traced("scca")
def scca(
    X,
    Y: np.ndarray,
    lambda1: float = 0.0,
    lambda2: float = 0.0,
    *,
    ndim: int = 10,
    stand_x: str = "binom2",
    stand_y: str = "sd",
    divisor: str = "p",
    maxiter: int = 500,
    tol: float = 1e-6,
    seed: int = 1,
    V0: np.ndarray | None = None,
    block_size: int | None = None,
    dtype=None,
    device=None,
    mesh=None,
    verbose: bool = False,
    auto_init: bool = False,
    engine: str = "auto",
    streaming: bool | str = "auto",
    memory_mb: int | None = None,
    state_out: str | None = None,
    state_in: str | None = None,
) -> SCCAResult:
    """SCCA of ``X`` (PLINK root/dataset, an (N, p) matrix, or a prebuilt
    wide operator) against the (N, k) phenotype matrix ``Y``.

    ``auto_init=True`` reproduces the R package's initialization: a
    first SCCA run at lambda ~= 0 (an approximate SVD of X^T Y) whose V
    seeds the penalized run (flashpcaR/R/scca.R:224-246).

    ``engine='device'`` runs each dimension's iteration on the
    operator's device in its dtype (:func:`_scca_dim_device_grid`);
    ``'host'`` drives it from the host one product at a time, in float64
    host arithmetic (the only engine of a streaming operator, the analog
    of the reference's disk-streaming SCCA, randompca.cpp:387-528);
    ``'auto'`` picks device for resident operators, host for streaming.

    ``state_out`` writes an .npz checkpoint after EVERY completed
    dimension; ``state_in`` resumes from one (of either package):
    finished dimensions are skipped and the run continues to the result
    of an uninterrupted run.  ``device`` defaults to ``cuda`` and raises
    without a GPU; ``device="cpu"`` runs the PyTorch path (float64 by
    default).  ``mesh`` shards the packed operator (parallel/dist.py);
    across processes only rank 0 writes ``state_out``."""
    if state_in is not None and V0 is None:
        auto_init = False      # the state carries the (possibly
        #                        auto-initialized) V0 already
    if auto_init and V0 is None:
        s0 = scca(
            X, Y, 1e-12, 1e-12, ndim=ndim, stand_x=stand_x,
            stand_y=stand_y, divisor=divisor, maxiter=maxiter, tol=tol,
            seed=seed, block_size=block_size, dtype=dtype, device=device,
            mesh=mesh, verbose=verbose, auto_init=False, engine=engine,
            streaming=streaming, memory_mb=memory_mb,
        )
        V0 = s0.V
    with span("scca/setup"):
        Y_std, invdiv = _scaled_y(Y, stand_y, divisor)
        n, k = Y_std.shape
        op = _xside_operator(
            X, n, k, ndim, stand_x, streaming=streaming,
            memory_mb=memory_mb, block_size=block_size, dtype=dtype,
            device=device, mesh=mesh)
    p = op.n_snps

    def xv(u_p):  # v-step product: X u, scaled
        return host64(op.prod(u_p)) * invdiv

    v0_explicit = V0 is not None
    V0 = _v0_of(V0, k, ndim, seed)
    V = V0.copy()
    U = np.zeros((p, ndim), dtype=np.float64)
    d = np.zeros(ndim, dtype=np.float64)
    n_iters = np.zeros(ndim, dtype=np.int64)

    start_dim = 0
    if state_in is not None:
        st = load_scca_state(state_in)
        if st["U"].shape != (p, ndim) or st["V"].shape != (k, ndim):
            raise ValueError(
                f"SCCA state has U {st['U'].shape} / V {st['V'].shape}; "
                f"expected ({p}, {ndim}) / ({k}, {ndim})")
        if (float(st["lambda1"]) != float(lambda1)
                or float(st["lambda2"]) != float(lambda2)):
            raise ValueError(
                "SCCA state was written under different penalties "
                f"(lambda1={float(st['lambda1']):g}, "
                f"lambda2={float(st['lambda2']):g}); resuming under new "
                "ones would mix deflation sequences")
        # the rest of the problem identity (keys absent from older
        # states are skipped, not rejected)
        for key, cur in (("divisor", divisor), ("stand_x", stand_x),
                         ("stand_y", stand_y)):
            if key in st and str(st[key]) != str(cur):
                raise ValueError(
                    f"SCCA state was written under {key}="
                    f"{str(st[key])!r}; resuming under {str(cur)!r} "
                    "would mix deflation sequences")
        if v0_explicit and not np.array_equal(st["V0"], V0):
            # a different explicit V0 contradicts the state; a default
            # (seed-generated) V0 yields to the checkpoint's
            raise ValueError(
                "explicit V0 differs from the checkpoint's V0")
        V0 = st["V0"]
        U, V, d = st["U"].copy(), st["V"].copy(), st["d"].copy()
        start_dim = int(st["next_dim"])
        log(f"resuming SCCA at dimension {start_dim} from {state_in}",
            verbose=verbose)

    def result(conv):
        with span("scca/result"):
            return SCCAResult(U=U, V=V, d=d, Px=xv(U), Py=Y_std @ V,
                              converged=conv, V0=V0, n_iters=n_iters)

    def finished(j, it):
        nzu = int(np.count_nonzero(U[:, j]))
        nzv = int(np.count_nonzero(V[:, j]))
        log(f"dim {j} finished in {it} iterations", verbose=verbose)
        log(f"U_{j} non-zeros: {nzu}, V_{j} non-zeros: {nzv}",
            verbose=verbose)
        log(f"d[{j}]: {d[j]}", verbose=verbose)
        if state_out is not None:
            if writer(op):
                save_scca_state(state_out, U, V, d, j + 1, V0,
                                lambda1, lambda2, divisor=divisor,
                                stand_x=stand_x, stand_y=stand_y)
            barrier(op)

    streamed = isinstance(op, StreamingPackedOperator)
    if engine == "auto":
        engine = "host" if streamed else "device"
    elif engine == "device" and streamed:
        raise ValueError(
            "engine='device' needs a resident operator (the streaming "
            "operator's products stage host blocks and cannot run inside "
            "the device iteration loop); use engine='host' or "
            "engine='auto'"
        )
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine: {engine}")

    # both engines are their grid engine's one-cell case
    if engine == "device":
        # restored columns (zeros when not resuming) as one-cell histories
        with span("scca/setup"):
            step = _DeviceGrid(op, Y_std, U[:, :, None], V[:, :, None],
                               [lambda1], [lambda2], invdiv, tol).dim
    else:
        lam1_c = np.array([lambda1], dtype=np.float64)
        lam2_c = np.array([lambda2], dtype=np.float64)

        def step(j, v0, alive, maxiter):
            return _scca_dim_host_grid(op, U[:, :, None], V[:, :, None],
                                       Y_std, j, v0, alive, lam1_c, lam2_c,
                                       invdiv, tol, maxiter, solo=True)

    alive = np.ones(1, dtype=bool)
    for j in range(start_dim, ndim):
        u_np, v_np, it_np, conv_np, uz_np, vz_np, dj_np = step(
            j, V0[:, j:j + 1], alive, maxiter)
        it = n_iters[j] = int(it_np[0])
        if bool(uz_np[0]):
            log(f"U[{j}] is all zero, {it}, l1 penalty too large",
                verbose=verbose)
        if bool(vz_np[0]):
            log(f"V[{j}] is all zero, {it}, l2 penalty too large",
                verbose=verbose)
        U[:, j] = u_np[:, 0]
        V[:, j] = v_np[:, 0]
        if j == 0 and (bool(uz_np[0]) or bool(vz_np[0])):
            return result(False)
        if not bool(conv_np[0]):
            log(f"SCCA did not converge in {maxiter} iterations",
                verbose=verbose)
            return result(False)
        d[j] = float(dj_np[0])
        finished(j, it)
    return result(True)


@dataclass
class SCCAGridResult:
    """Per-cell results of a batched penalty-grid SCCA run.

    Cells are row-major over the (lambda1, lambda2) cross-product
    (cell ``c = i * len(lambda2_axis) + j``) unless ``pairs=True`` zips
    the penalty lists.  ``converged[c]`` is True only when every
    dimension of cell c converged (as ``SCCAResult.converged`` of a solo
    run)."""

    lambda1: np.ndarray    # (C,) per-cell l1 penalty
    lambda2: np.ndarray    # (C,) per-cell l2 penalty
    U: np.ndarray          # (p, ndim, C) X-side weights per cell
    V: np.ndarray          # (k, ndim, C) Y-side weights per cell
    d: np.ndarray          # (ndim, C) canonical covariances
    converged: np.ndarray  # (C,) bool
    n_iters: np.ndarray    # (ndim, C) iterations per dimension
    V0: np.ndarray         # (k, ndim) shared init panel

    def __repr__(self):
        return (f"SCCAGridResult(cells={len(self.lambda1)}, "
                f"ndim={self.d.shape[0]}, "
                f"converged={int(self.converged.sum())})")


def scca_grid(
    X,
    Y: np.ndarray,
    lambda1,
    lambda2,
    *,
    pairs: bool = False,
    ndim: int = 10,
    stand_x: str = "binom2",
    stand_y: str = "sd",
    divisor: str = "p",
    maxiter: int = 500,
    tol: float = 1e-6,
    seed: int = 1,
    V0: np.ndarray | None = None,
    block_size: int | None = None,
    dtype=None,
    device=None,
    mesh=None,
    verbose: bool = False,
    auto_init: bool = False,
    streaming: bool | str = "auto",
    memory_mb: int | None = None,
) -> SCCAGridResult:
    """SCCA over a whole (lambda1, lambda2) penalty grid in one batched
    run: every cell advances through SHARED genotype passes.

    The reference runs each grid cell as its own process (scca.sh:65-79)
    or an lapply (scca.R:291-300), C full SCCA runs.  Here the
    per-iteration ``X^T (Y v)`` / ``X u`` products of all C cells ride
    ONE C-column panel pass, so the grid costs about the slowest cell's
    iterations in passes instead of the sum.  Per-cell math is
    ``scca(engine='device')``'s with the same shared ``V0``: frozen
    cells are masked out of the updates.

    ``lambda1``/``lambda2`` are 1-D penalty axes crossed row-major into
    C = len(lambda1) x len(lambda2) cells; ``pairs=True`` zips them
    instead (C = len(lambda1) = len(lambda2)).  ``V0`` (k, ndim) seeds
    every cell (the cv.scca convention, scca.R:291-300); ``auto_init``
    derives it from one near-zero-penalty solo run.  Dimensions never
    reached keep their V0 columns.

    Resident operators run the device engine (the per-cell histories
    add 2 * p * ndim * C elements of the operator's dtype on its
    device); a streaming operator runs the host grid engine
    (:func:`_scca_dim_host_grid`), whose cells share each staged pass.
    """
    l1_axis = np.atleast_1d(np.asarray(lambda1, dtype=np.float64))
    l2_axis = np.atleast_1d(np.asarray(lambda2, dtype=np.float64))
    if pairs:
        if len(l1_axis) != len(l2_axis):
            raise ValueError(
                "pairs=True needs lambda1 and lambda2 of equal length")
        lam1_c, lam2_c = l1_axis.copy(), l2_axis.copy()
    else:
        lam1_c = np.repeat(l1_axis, len(l2_axis))
        lam2_c = np.tile(l2_axis, len(l1_axis))
    C = len(lam1_c)

    if auto_init and V0 is None:
        s0 = scca(X, Y, 1e-12, 1e-12, ndim=ndim, stand_x=stand_x,
                  stand_y=stand_y, divisor=divisor, maxiter=maxiter,
                  tol=tol, seed=seed, block_size=block_size, dtype=dtype,
                  device=device, mesh=mesh, verbose=verbose,
                  auto_init=False, streaming=streaming, memory_mb=memory_mb)
        V0 = s0.V

    Y_std, invdiv = _scaled_y(Y, stand_y, divisor)
    n, k = Y_std.shape
    op = _xside_operator(
        X, n, k, ndim, stand_x, streaming=streaming, memory_mb=memory_mb,
        block_size=block_size, dtype=dtype, device=device, mesh=mesh,
        who="scca_grid")
    p = op.n_snps
    V0 = _v0_of(V0, k, ndim, seed)

    U_host = np.zeros((p, ndim, C), dtype=np.float64)
    # dimensions never reached keep their V0 columns, like a solo run
    V_host = np.broadcast_to(V0[:, :, None], (k, ndim, C)).copy()
    d_host = np.zeros((ndim, C), dtype=np.float64)
    n_iters = np.zeros((ndim, C), dtype=np.int64)
    alive = np.ones(C, dtype=bool)
    conv_all = np.ones(C, dtype=bool)

    # streaming operators stage host blocks inside their products: they
    # ride the host-driven batched engine (same shared-pass win)
    host_engine = isinstance(op, StreamingPackedOperator)
    if not host_engine:
        grid = _DeviceGrid(op, Y_std, U_host, V_host, lam1_c, lam2_c,
                           invdiv, tol)

    for j in range(ndim):
        if not alive.any():
            break
        v0_j = np.broadcast_to(V0[:, j][:, None], (k, C))
        if host_engine:
            u_np, v_np, it_np, conv_np, uz_np, vz_np, dj_np = (
                _scca_dim_host_grid(op, U_host, V_host, Y_std, j, v0_j,
                                    alive, lam1_c, lam2_c, invdiv, tol,
                                    maxiter))
        else:
            u_np, v_np, it_np, conv_np, uz_np, vz_np, dj_np = grid.dim(
                j, v0_j, alive, maxiter)
        started = alive.copy()
        U_host[:, j, started] = u_np[:, started]
        V_host[:, j, started] = v_np[:, started]
        n_iters[j, started] = it_np[started]
        for c in np.flatnonzero(started):
            if uz_np[c]:
                log(f"[cell {c}] U[{j}] is all zero, {int(it_np[c])}, "
                    "l1 penalty too large", verbose=verbose)
            if vz_np[c]:
                log(f"[cell {c}] V[{j}] is all zero, {int(it_np[c])}, "
                    "l2 penalty too large", verbose=verbose)
            if j == 0 and (uz_np[c] or vz_np[c]):
                alive[c] = False
                conv_all[c] = False
            elif not conv_np[c]:
                log(f"[cell {c}] SCCA did not converge in {maxiter} "
                    "iterations", verbose=verbose)
                alive[c] = False
                conv_all[c] = False
            else:
                d_host[j, c] = dj_np[c]
                log(f"[cell {c}] dim {j} finished in {int(it_np[c])} "
                    "iterations", verbose=verbose)

    return SCCAGridResult(
        lambda1=lam1_c, lambda2=lam2_c, U=U_host, V=V_host, d=d_host,
        converged=conv_all, n_iters=n_iters, V0=V0,
    )


# ---------------------------------------------------------------------------
# Penalty selection: k-fold cross-validation (split validation:
# models/scca_split.py)
# ---------------------------------------------------------------------------

# scca() keywords the batched grid engine understands: the one definition
# that cv_scca and split_scca share (each adds its own extras through
# grid_fastpath), so that neither is stranded on the C-times-slower
# sequential fallback by a keyword the other accepts.  ``device`` is the
# port's own: every call that names its device must ride the grid too.
GRID_COMPAT_KWARGS = frozenset({
    "divisor", "maxiter", "tol", "seed", "dtype", "device", "mesh",
    "block_size", "auto_init",
})
# resolved by the caller (operator choice, engine gate) and dropped
# before forwarding to scca_grid, which takes none of them
_GRID_RESOLVED_KWARGS = frozenset({"engine", "streaming", "memory_mb"})


def grid_fastpath(scca_kwargs, *extra):
    """Whether ``scca_kwargs`` can ride the batched grid engine.

    Returns ``(ok, gkw)``: ``ok`` is False when the caller forced the
    host engine or passed a keyword the grid engine does not understand
    (the caller falls back to sequential per-cell scca() runs); ``gkw``
    is the keywords to forward to :func:`scca_grid`.  ``extra`` lists
    caller-specific keywords that are also acceptable (cv_scca forwards
    stand_x/stand_y; split_scca resolves them itself but may forward
    V0)."""
    allowed = GRID_COMPAT_KWARGS | _GRID_RESOLVED_KWARGS
    for names in extra:
        allowed = allowed | frozenset(names)
    eng = scca_kwargs.get("engine", "auto")
    ok = eng in ("auto", "device") and set(scca_kwargs) <= allowed
    if (eng == "device"
            and (scca_kwargs.get("streaming") is True
                 or scca_kwargs.get("memory_mb") is not None)):
        # solo scca() raises on engine='device' with a streaming
        # operator: the sequential path surfaces that same error instead
        # of quietly running the host-driven grid
        ok = False
    gkw = {kk: vv for kk, vv in scca_kwargs.items()
           if kk not in _GRID_RESOLVED_KWARGS}
    return ok, gkw


@dataclass
class CVSCCAResult:
    """k-fold cross-validation over a (lambda1, lambda2) grid
    (equivalent of flashpcaR::cv.scca, scca.R:410-557)."""

    ndim: int
    lambda1: np.ndarray
    lambda2: np.ndarray
    opt_dim: int
    best_lambda1: float
    best_lambda2: float
    best_corr: float
    corr: np.ndarray       # (ndim, len(l1), len(l2)) pooled test correlation
    nzero_x: np.ndarray    # (ndim, len(l1), len(l2)) mean non-zeros in U
    nzero_y: np.ndarray
    nfolds: int
    converged: np.ndarray  # (nfolds, len(l1), len(l2))
    folds: np.ndarray      # (n,) fold assignment, 0-based

    def __repr__(self):
        return (f"CVSCCAResult(best_lambda1={self.best_lambda1:g}, "
                f"best_lambda2={self.best_lambda2:g}, "
                f"best_corr={self.best_corr:.4f})")


def _penalty_axis(lam, default):
    return np.atleast_1d(np.asarray(lam if lam is not None else default,
                                    dtype=np.float64))


def _cv_setup(Y, n, lambda1, lambda2, ndim, nfolds, folds, opt_dim, seed):
    """What both CV paths check and draw first, in the JAX package's
    order: Y as (n, k) float64, the penalty axes, and the folds (explicit,
    or ``default_rng(seed).integers``; the same generator then draws each
    fold's init V0).  Returns (Y, lambda1, lambda2, rng, folds,
    nfolds)."""
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    lambda1 = _penalty_axis(lambda1, np.linspace(1e-6, 1e-3, 5))
    lambda2 = _penalty_axis(lambda2, np.linspace(1e-6, 1e-3, 5))
    if not (1 <= opt_dim <= ndim):
        raise ValueError("opt_dim must be between 1 and ndim")
    rng = np.random.default_rng(seed)
    if folds is not None:
        folds = np.asarray(folds, dtype=np.int64)
        if folds.shape != (n,):
            raise ValueError("folds must have one entry per sample")
        nfolds = int(folds.max()) + 1
    else:
        if nfolds > n:
            raise ValueError("nfolds is too large for the number of samples")
        folds = rng.integers(0, nfolds, size=n)
    return Y, lambda1, lambda2, rng, folds, nfolds


class _CVTally:
    """The pooled test-row predictions, the mean non-zeros and the
    convergence of every (fold, cell)."""

    def __init__(self, n, ndim, n1, n2, nfolds):
        self.xpred = np.full((n, ndim, n1, n2), np.nan)
        self.ypred = np.full((n, ndim, n1, n2), np.nan)
        self.nzx = np.zeros((ndim, n1, n2))
        self.nzy = np.zeros((ndim, n1, n2))
        self.conv = np.zeros((nfolds, n1, n2), dtype=bool)
        self.nfolds = nfolds

    def add(self, fold, i, j, U, V, converged, test, px, py):
        """One cell's fit on one fold; ``px`` / ``py`` (thunks) give its
        test rows' predictions, taken only where it converged (a fold
        whose test set is empty passes ``px=None``)."""
        self.conv[fold, i, j] = converged
        self.nzx[:, i, j] += np.count_nonzero(U, axis=0) / self.nfolds
        self.nzy[:, i, j] += np.count_nonzero(V, axis=0) / self.nfolds
        if converged and px is not None:
            self.xpred[test, :, i, j] = px()
            self.ypred[test, :, i, j] = py()


def _fold_grid(tally, fold, g, n2, test, px, Y_test):
    """Tally a fold's scca_grid result ``g``; ``px(c)`` gives cell c's
    test projections (``px`` None: the fold has no test rows)."""
    for c in range(len(g.lambda1)):
        i, j = divmod(c, n2)
        tally.add(fold, i, j, g.U[:, :, c], g.V[:, :, c], g.converged[c],
                  test, None if px is None else (lambda c=c: px(c)),
                  lambda c=c: Y_test @ g.V[:, :, c])


def cv_scca(
    X,
    Y: np.ndarray,
    lambda1=None,
    lambda2=None,
    *,
    ndim: int = 3,
    nfolds: int = 10,
    folds: np.ndarray | None = None,
    opt_dim: int = 1,
    init: bool = True,
    seed: int = 1,
    verbose: bool = False,
    workdir: str | None = None,
    **scca_kwargs,
) -> CVSCCAResult:
    """Cross-validated SCCA penalty selection.

    glmnet-style pooling (scca.R:497-523): per fold, train on the
    complement and write the test rows' predictions ``X[test] U`` /
    ``Y[test] V`` into pooled arrays; each dimension's score is the
    Pearson correlation of the pooled predictions.  A model that did not
    converge leaves its fold's predictions NaN.  ``init=True`` seeds
    every fold's grid with the V of a near-zero-penalty run on that
    fold's training data.

    ``X`` is a numeric (N, p) matrix (one :class:`DenseOperator` a fold,
    float64 unless ``dtype`` says otherwise) or a PLINK root /
    :class:`PlinkDataset`: that path keeps the genotypes 2-bit packed
    through the whole CV (a ``subset_samples`` repack a fold, packed
    train operators, a packed raw-dosage test projection) and honors
    ``streaming`` / ``memory_mb``.  ``workdir`` is where the fold
    filesets are written and kept; by default they go to a temporary
    directory and are deleted as each fold completes.  Further keywords
    go to :func:`scca` / :func:`scca_grid`; ``device`` defaults to
    ``cuda`` and raises without a GPU."""
    for bad in ("state_out", "state_in"):
        if bad in scca_kwargs:
            raise ValueError(
                f"{bad} cannot be forwarded to a penalty grid: every "
                "(fold, lambda) cell would overwrite the same file; "
                "checkpoint individual scca() runs instead")
    if isinstance(X, (str, PlinkDataset)):
        return _cv_scca_plink(
            X, Y, lambda1, lambda2, ndim=ndim, nfolds=nfolds,
            folds=folds, opt_dim=opt_dim, init=init, seed=seed,
            verbose=verbose, workdir=workdir, **scca_kwargs)
    # matrix CV has no bounded-memory path: an explicit streaming /
    # memory_mb request would otherwise vanish into the grid fast
    # path's resolved-keyword filter
    if (scca_kwargs.get("streaming") is True
            or scca_kwargs.get("memory_mb") is not None):
        raise ValueError(
            "an explicit streaming/memory_mb request needs packed "
            "genotypes: pass the PLINK root (or PlinkDataset) as X "
            "instead of a dense matrix"
        )
    from ._common import matrix_operator

    X = np.asarray(X, dtype=np.float64)
    n = np.shape(Y)[0]
    if X.shape[0] != n:
        raise ValueError("X and Y must have the same number of rows")
    Y, lambda1, lambda2, rng, folds, nfolds = _cv_setup(
        Y, n, lambda1, lambda2, ndim, nfolds, folds, opt_dim, seed)
    n2 = len(lambda2)
    tally = _CVTally(n, ndim, len(lambda1), n2, nfolds)

    # the CV seed also seeds the inner runs' V0 (the init=False path)
    scca_kwargs.setdefault("seed", seed)
    grid_ok, gkw = grid_fastpath(scca_kwargs, ("stand_x", "stand_y"))
    if not grid_ok:
        log("cv_scca: sequential per-cell fallback (host engine or "
            "keywords outside GRID_COMPAT_KWARGS)", verbose=verbose)
    # one standardization and DenseOperator a fold, shared by the init
    # run, the grid and every sequential cell; stand_y still applies
    # inside scca()
    cv_stand_x = scca_kwargs.pop("stand_x", "binom2")
    gkw.pop("stand_x", None)
    if scca_kwargs.get("mesh") is not None:
        # as solo scca()'s dense path in the JAX package: noted, ignored
        log("note: the dense-matrix SCCA path runs unsharded; mesh= is "
            "ignored (use the packed PLINK path for SNP sharding)")
        scca_kwargs.pop("mesh")
        gkw.pop("mesh", None)
    dtype, device = scca_kwargs.get("dtype"), scca_kwargs.get("device")

    for fold in range(nfolds):
        train = folds != fold
        test = ~train
        log(f"-> fold {fold + 1}/{nfolds}", verbose=verbose)
        op_tr = matrix_operator(X[train], cv_stand_x, dtype, device)
        V0 = None
        if init:
            V0g = rng.standard_normal((Y.shape[1], ndim))
            V0 = scca(op_tr, Y[train], 1e-12, 1e-12, ndim=ndim, V0=V0g,
                      verbose=verbose, **scca_kwargs).V
        if grid_ok:
            g = scca_grid(op_tr, Y[train], lambda1, lambda2, ndim=ndim,
                          V0=V0, verbose=verbose, **gkw)
            _fold_grid(tally, fold, g, n2, test,
                       lambda c: X[test] @ g.U[:, :, c], Y[test])
            continue
        for i, l1 in enumerate(lambda1):
            for j, l2 in enumerate(lambda2):
                res = scca(op_tr, Y[train], float(l1), float(l2),
                           ndim=ndim, V0=V0, verbose=verbose, **scca_kwargs)
                tally.add(fold, i, j, res.U, res.V, res.converged, test,
                          lambda: X[test] @ res.U, lambda: Y[test] @ res.V)
    return _cv_pooled_result(tally, lambda1, lambda2, ndim, opt_dim, folds)


def _cv_pooled_result(tally, lambda1, lambda2, ndim, opt_dim,
                      folds) -> CVSCCAResult:
    """Pooled-prediction scoring shared by the matrix and PLINK CV
    paths (glmnet-style, scca.R:497-523), in numpy."""
    n1, n2 = len(lambda1), len(lambda2)
    corr = np.full((ndim, n1, n2), np.nan)
    with np.errstate(invalid="ignore", divide="ignore"):
        for d_ in range(ndim):
            for i in range(n1):
                for j in range(n2):
                    a = tally.xpred[:, d_, i, j]
                    b = tally.ypred[:, d_, i, j]
                    ok = ~(np.isnan(a) | np.isnan(b))
                    if ok.sum() > 1 and a[ok].std() > 0 and b[ok].std() > 0:
                        corr[d_, i, j] = np.corrcoef(a[ok], b[ok])[0, 1]

    sl = corr[opt_dim - 1]
    if np.all(np.isnan(sl)):
        raise RuntimeError("no cv.scca model converged on any penalty pair")
    best = np.unravel_index(np.nanargmax(sl), sl.shape)
    return CVSCCAResult(
        ndim=ndim, lambda1=lambda1, lambda2=lambda2, opt_dim=opt_dim,
        best_lambda1=float(lambda1[best[0]]),
        best_lambda2=float(lambda2[best[1]]),
        best_corr=float(sl[best]), corr=corr,
        nzero_x=tally.nzx, nzero_y=tally.nzy, nfolds=tally.nfolds,
        converged=tally.conv, folds=folds,
    )


def _plink_operator_options(scca_kwargs):
    """The operator keywords of a packed penalty search (cv_scca's and
    split_scca's PLINK paths), taken out of ``scca_kwargs``: the inner
    scca()/scca_grid() calls get prebuilt operators, whose conflict
    check would refuse them, ``mesh`` among them (every operator is
    built on it).  An explicit device engine refuses a streaming request
    as solo scca() does."""
    if (scca_kwargs.get("engine") == "device"
            and (scca_kwargs.get("streaming") is True
                 or scca_kwargs.get("memory_mb") is not None)):
        raise ValueError(
            "engine='device' needs a resident operator; use "
            "engine='host' or engine='auto' with streaming/memory_mb")
    opts = dict(streaming=scca_kwargs.pop("streaming", "auto"),
                memory_mb=scca_kwargs.pop("memory_mb", None),
                block_size=scca_kwargs.pop("block_size", None),
                dtype=scca_kwargs.get("dtype"),
                device=scca_kwargs.get("device"),
                mesh=scca_kwargs.pop("mesh", None))
    return opts


def search_device(op_opts):
    """The validated device of a penalty search's operators, before any
    repack (without a GPU the default raises here): the mesh's, when it
    has one."""
    mesh, device = op_opts["mesh"], op_opts["device"]
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != \
            mesh.devices[0].type:
        raise ValueError(f"device={device} conflicts with the mesh's "
                         f"devices ({mesh.devices[0].type})")
    return resolve_device(mesh.devices[0])


def shared_repack(mesh, workdir, repack) -> None:
    """Run ``repack()`` (the writing of a search's scratch filesets)
    once: under a mesh that spans processes and a shared ``workdir``,
    rank 0 writes and the others wait; each process's own scratch
    directory it writes itself."""
    if mesh is None or not mesh.multiprocess or workdir is None:
        repack()
        return
    if mesh.is_writer:
        repack()
    mesh.barrier()


def _refuse_auto_streamed(scca_kwargs, op):
    """An operator that streamed under streaming='auto' meets an explicit
    device engine with the error an explicit request gets."""
    if (scca_kwargs.get("engine") == "device"
            and isinstance(op, StreamingPackedOperator)):
        raise ValueError(
            "engine='device' needs a resident operator, but this dataset "
            "auto-streams; use engine='host'/'auto'")


def _project_cells(op, U):
    """``X U`` for every cell's U (p, ndim, C) in ONE product through the
    operator (a panel of ndim * C columns), as (rows, ndim, C) float64."""
    p, ndim, C = U.shape
    panel = torch.as_tensor(U.reshape(p, ndim * C), dtype=op.dtype,
                            device=op.device)
    return host64(op.prod(panel)).reshape(-1, ndim, C)


def _cv_scca_plink(data, Y, lambda1, lambda2, *, ndim, nfolds, folds,
                   opt_dim, init, seed, verbose, workdir=None,
                   **scca_kwargs) -> CVSCCAResult:
    """k-fold CV over a PLINK fileset with the genotypes 2-bit packed
    throughout (reference analog: scca.R:410-557's k-fold and
    scca.sh's plink-subset workflow).  Per fold the train and test
    samples are repacked from one read of the source
    (:func:`io.plink.subset_samples_many`), the train
    operator standardizes with the fold's training stats, and the test
    projection ``X[test] @ U`` runs through a raw-dosage packed operator
    (mean 0, sd 1: the matrix path's unstandardized ``X[test] @ U``;
    a missing genotype contributes 0 where the matrix path's NaN drops
    the row), all cells in one product.  ``streaming`` / ``memory_mb``
    bound each fold's device memory."""
    import os
    import tempfile

    from ..io.plink import subset_samples_many

    ds = PlinkDataset.open(data) if isinstance(data, str) else data
    n = ds.n_samples
    if np.shape(Y)[0] != n:
        raise ValueError("Y rows must match the number of samples")
    Y, lambda1, lambda2, rng, folds, nfolds = _cv_setup(
        Y, n, lambda1, lambda2, ndim, nfolds, folds, opt_dim, seed)
    stand_x = scca_kwargs.get("stand_x", "binom2")
    op_opts = _plink_operator_options(scca_kwargs)
    op_opts["device"] = search_device(op_opts)

    # without an explicit workdir the fold filesets are scratch, each
    # fold's deleted once used (nfolds x the dataset otherwise); an
    # explicit workdir keeps them
    cleanup = workdir is None
    if cleanup:
        workdir = tempfile.mkdtemp(prefix="cv_scca_")
    else:
        os.makedirs(workdir, exist_ok=True)
    base = os.path.basename(ds.bed_path)[:-4]

    n2 = len(lambda2)
    tally = _CVTally(n, ndim, len(lambda1), n2, nfolds)
    # the CV seed also seeds the inner runs' V0 (the init=False path)
    scca_kwargs.setdefault("seed", seed)
    grid_ok, gkw = grid_fastpath(scca_kwargs, ("stand_x", "stand_y"))
    if not grid_ok:
        log("cv_scca: sequential per-cell fallback (host engine or "
            "keywords outside GRID_COMPAT_KWARGS)", verbose=verbose)

    for fold in range(nfolds):
        train = folds != fold
        test = ~train
        log(f"-> fold {fold + 1}/{nfolds}", verbose=verbose)
        test_idx = np.flatnonzero(test)
        subsets = [(np.flatnonzero(train),
                    os.path.join(workdir, f"{base}_f{fold}_train"))]
        if test_idx.size:
            subsets.append((test_idx, os.path.join(
                workdir, f"{base}_f{fold}_test")))
        fold_roots = [root for _, root in subsets]
        # the whole fold sits inside the try, so that a failure anywhere
        # still removes the fold's scratch filesets
        try:
            shared_repack(op_opts["mesh"], None if cleanup else workdir,
                          lambda: subset_samples_many(ds, subsets))
            ds_tr = PlinkDataset.open(fold_roots[0])
            op_te = None
            if test_idx.size:
                ds_te = PlinkDataset.open(fold_roots[1])
                # the raw-dosage test projector (see the docstring)
                op_te = build_packed_operator(
                    ds_te, np.zeros(ds_te.n_snps), np.ones(ds_te.n_snps),
                    **op_opts)
            # an empty test fold (an unused label) trains and counts as
            # the matrix path does, and projects nothing
            xm, xs = ds_tr.snp_stats(stand_x)
            op_tr = build_packed_operator(ds_tr, xm, xs, **op_opts)
            _refuse_auto_streamed(scca_kwargs, op_tr)
            V0 = None
            if init:
                V0g = rng.standard_normal((Y.shape[1], ndim))
                V0 = scca(op_tr, Y[train], 1e-12, 1e-12, ndim=ndim,
                          V0=V0g, verbose=verbose, **scca_kwargs).V
            if grid_ok:
                g = scca_grid(op_tr, Y[train], lambda1, lambda2,
                              ndim=ndim, V0=V0, verbose=verbose, **gkw)
                px = None
                if op_te is not None:
                    px_all = _project_cells(op_te, g.U)
                    px = lambda c: px_all[:, :, c]      # noqa: E731
                _fold_grid(tally, fold, g, n2, test, px, Y[test])
                continue
            for i, l1 in enumerate(lambda1):
                for j, l2 in enumerate(lambda2):
                    res = scca(op_tr, Y[train], float(l1), float(l2),
                               ndim=ndim, V0=V0, verbose=verbose,
                               **scca_kwargs)
                    tally.add(fold, i, j, res.U, res.V, res.converged,
                              test, None if op_te is None else
                              (lambda: host64(op_te.prod(res.U))),
                              lambda: Y[test] @ res.V)
        finally:
            if cleanup:
                # the memmaps keep their descriptors; unlinking is safe
                # and bounds the scratch at one fold
                for root in fold_roots:
                    for ext in (".bed", ".bim", ".fam"):
                        try:
                            os.remove(root + ext)
                        except OSError:
                            pass
    if cleanup:
        try:
            os.rmdir(workdir)
        except OSError:
            pass
    return _cv_pooled_result(tally, lambda1, lambda2, ndim, opt_dim, folds)
