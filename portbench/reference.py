"""The plain float64 reference the benchmark judges the program by.

Plain PyTorch on the packed PLINK bytes, in blocks of SNP rows so that
it fits beside the data on the card.  It imports nothing of the program
(nor JAX): the per-SNP standardization is worked out again here from
the bytes, by the reference's rules (flashpca's ``binom2``: mean over
the non-missing dosages, ``sd = sqrt(2 f (1 - f))`` with ``f`` half the
mean, a missing call standardized to 0, a SNP whose sd is at most 1e-9
zeroed).  The program's outputs are read only to be judged.
"""

from __future__ import annotations

import numpy as np
import torch

VAR_TOL = 1e-9
ROWS = 256           # SNPs decoded to float64 a block


def codes(block: torch.Tensor, n: int) -> torch.Tensor:
    """(b, nbytes) packed bytes -> (b, n) PLINK codes, natural order."""
    planes = [(block >> (2 * s)) & 3 for s in range(4)]
    return torch.stack(planes, dim=2).reshape(block.shape[0], -1)[:, :n]


def binom2_stats(packed: torch.Tensor, n: int, rows: int = 2048):
    """(mean, inverse sd) a SNP, float64 on the bytes' device."""
    mean, inv = [], []
    for r0 in range(0, packed.shape[0], rows):
        c = codes(packed[r0: r0 + rows], n)
        good = (c != 1).sum(dim=1, dtype=torch.int64).double()
        dos = ((c == 0).sum(dim=1, dtype=torch.int64) * 2
               + (c == 2).sum(dim=1, dtype=torch.int64)).double()
        m = torch.where(good > 0, dos / good.clamp(min=1), 0.0)
        f = m / 2
        sd = torch.sqrt(2 * f * (1 - f))
        iv = torch.where(sd > VAR_TOL, 1.0 / sd.clamp(min=VAR_TOL), 0.0)
        mean.append(torch.where(iv > 0, m, 0.0))
        inv.append(iv)
    return torch.cat(mean), torch.cat(inv)


def standardized(block: torch.Tensor, n: int, mean: torch.Tensor,
                 inv: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(b, nbytes) bytes -> (b, n) standardized genotypes, computed in
    ``dtype``."""
    c = codes(block, n)
    dosage = (2 - (c & 1) - (c >> 1)).to(dtype)
    x = (dosage - mean[:, None].to(dtype)) * inv[:, None].to(dtype)
    return x.masked_fill_(c == 1, 0.0)


def gram_columns(packed: torch.Tensor, n: int, mean, inv,
                 U: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """X X^T U in float64 for an (n, m) float64 panel U on the card:
    X is (n samples, p SNPs), decoded a block of SNP rows at a time."""
    acc = torch.zeros_like(U)
    for r0 in range(0, packed.shape[0], rows):
        B = standardized(packed[r0: r0 + rows], n, mean[r0: r0 + rows],
                         inv[r0: r0 + rows])                     # (b, n)
        acc.addmm_(B.T, B @ U)
    return acc


def residual_err(XXU: torch.Tensor, U: torch.Tensor, d: np.ndarray,
                 divisor: float) -> np.ndarray:
    """Each column's sum of (X X^T u / div - u d)^2: flashpca's check
    statistic is their sum over a job's k columns / (n k)."""
    D = torch.as_tensor(d, dtype=torch.float64, device=U.device)
    R = XXU / divisor - U * D[None, :]
    return (R * R).sum(dim=0).cpu().numpy()


def cross_and_prod(packed: torch.Tensor, n: int, mean, inv,
                   Yv: torch.Tensor, u: torch.Tensor, rows: int = ROWS):
    """(X^T Yv, X u) in float64 in one decode pass: Yv (n, m), u (p, m)."""
    z = torch.empty((packed.shape[0], Yv.shape[1]), dtype=torch.float64,
                    device=Yv.device)
    xu = torch.zeros((n, u.shape[1]), dtype=torch.float64, device=u.device)
    for r0 in range(0, packed.shape[0], rows):
        B = standardized(packed[r0: r0 + rows], n, mean[r0: r0 + rows],
                         inv[r0: r0 + rows])
        z[r0: r0 + B.shape[0]] = B @ Yv
        xu.addmm_(B.T, u[r0: r0 + B.shape[0]])
    return z, xu


def rows_product(packed: torch.Tensor, n: int, mean, inv, idx,
                 w: torch.Tensor) -> torch.Tensor:
    """X[:, idx] w in float64, decoding only the SNPs ``idx``."""
    idx = torch.as_tensor(idx, device=packed.device)
    B = standardized(packed[idx], n, mean[idx], inv[idx])
    return B.T @ w


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits, to
    nearest, ties away from zero), as the tensor cores round a TF32
    product's inputs; the product itself then runs in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gram_schmidt(x: torch.Tensor, basis: torch.Tensor, j: int):
    """x orthogonalized against basis[:, :j], one column at a time."""
    for t in range(j):
        b = basis[:, t]
        nb = b @ b
        if nb > 0:
            x = x - (x @ b) * b / nb
    return x


def norm_thresh(x: torch.Tensor, lam: float) -> torch.Tensor:
    """Normalize, soft-threshold by lam, normalize again (zero stays)."""
    s = torch.linalg.vector_norm(x)
    if s == 0:
        return x
    x = x / s
    x = torch.sign(x) * torch.clamp(x.abs() - lam, min=0.0)
    s = torch.linalg.vector_norm(x)
    return x / s if s > 0 else x


def scca(packed: torch.Tensor, n: int, mean, inv, Y: torch.Tensor,
         V0: torch.Tensor, lam1: float, lam2: float, maxiter: int,
         tol: float, dtype=torch.float64, tf32: bool = False,
         rows: int = 2048):
    """Sparse CCA of the standardized genotypes X against the
    standardized phenotypes ``Y`` (n, k), one dimension after another
    from the starts ``V0`` (k, ndim), by the reference's alternating
    iteration (flashpca randompca.cpp scca): u = S(X^T Y v) and v =
    S(Y^T X u), each orthogonalized against the earlier dimensions'
    vectors and soft-thresholded (``lam1``, ``lam2``), until neither
    moves by ``tol``; d = (X u)^T (Y v).  The products decode X a block
    of SNP rows at a time into ``dtype``; ``tf32`` rounds both inputs
    of every float32 product to TF32 first (by hand: cuBLAS rounds only
    matrix-matrix products, and these are matrix-vector ones).  Returns
    (U, V, d, iterations, converged), float64 on the host."""
    p, k = packed.shape[0], Y.shape[1]
    ndim = V0.shape[1]
    dev = packed.device
    Y = Y.to(dev, dtype)
    rnd = round_tf32 if tf32 else (lambda t: t)

    def blocks():
        for r0 in range(0, p, rows):
            yield r0, rnd(standardized(packed[r0: r0 + rows], n,
                                       mean[r0: r0 + rows],
                                       inv[r0: r0 + rows], dtype))

    def cross(y):                           # X^T y: (n,) -> (p,)
        y = rnd(y)
        z = torch.empty(p, dtype=dtype, device=dev)
        for r0, B in blocks():
            z[r0: r0 + B.shape[0]] = B @ y
        return z

    def prod(u):                            # X u: (p,) -> (n,)
        u = rnd(u)
        acc = torch.zeros(n, dtype=dtype, device=dev)
        for r0, B in blocks():
            acc += B.T @ u[r0: r0 + B.shape[0]]
        return acc

    U = torch.zeros((p, ndim), dtype=dtype, device=dev)
    V = torch.zeros((k, ndim), dtype=dtype, device=dev)
    d = torch.zeros(ndim, dtype=torch.float64)
    iters = [0] * ndim
    ok = True
    for j in range(ndim):
        v = V0[:, j].to(dev, dtype)
        u = torch.zeros(p, dtype=dtype, device=dev)
        du = dv = float("inf")
        it = 0
        while it < maxiter and (it == 0 or du >= tol or dv >= tol):
            u1 = norm_thresh(gram_schmidt(cross(Y @ v), U, j), lam1)
            v1 = norm_thresh(gram_schmidt(Y.T @ prod(u1), V, j), lam2)
            du = float((u1 - u).abs().max())
            dv = float((v1 - v).abs().max())
            u, v = u1, v1
            it += 1
        iters[j] = it
        ok = ok and du < tol and dv < tol
        U[:, j], V[:, j] = u, v
        d[j] = float(prod(u) @ (Y @ v))
    return (U.double().cpu().numpy(), V.double().cpu().numpy(),
            d.numpy(), iters, ok)
