"""``scca`` fits on phenotypes with planted sparse directions.

Fit ``i`` is ``scca(op, Y, lambda1, lambda2)`` from the start V0 of
seed ``i + v0_seed_offset``, on phenotypes made in set-up from
``pheno_seed``: ``n_pheno`` standard normal columns, the first ``ndim``
of which carry X u* for a ``planted``-SNP unit direction u*, at
``effect`` / sd.  ``control`` puts the reference in the program's
place, its products in TF32 (the configuration's float32 with TF32
off, one step down).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench import reference


class Kind:
    def __init__(self, traffic: dict, cohort, control=False):
        self.t = traffic
        self.c = cohort
        self.control = control
        self.Y = phenotypes(traffic, cohort)
        self.lam1 = traffic["lambda1_sqrt_p"] / np.sqrt(cohort.p)

    def v0(self, i: int) -> np.ndarray:
        """The fit's start, drawn as flashpca_tpu_torch documents its
        ``seed=`` (numpy's PCG64 standard normals, k x ndim)."""
        t = self.t
        return np.random.default_rng(i + t["v0_seed_offset"]).standard_normal(
            (t["n_pheno"], t["ndim"]))

    def run(self, i: int, rec) -> dict:
        from flashpca_tpu_torch import scca

        t = self.t
        with rec.entry("scca") as ts:
            if self.control:
                res = self._reference_tf32(i)
            else:
                res = scca(self.c.op, self.Y, self.lam1, t["lambda2"],
                           ndim=t["ndim"], maxiter=t["maxiter"],
                           tol=t["tol"], seed=i + t["v0_seed_offset"])
        return {"index": i, "scca_s": ts["seconds"],
                "iters": int(np.sum(res.n_iters)),
                "converged": bool(res.converged), "U": res.U, "V": res.V,
                "d": res.d, "V0": res.V0}

    def _reference_tf32(self, i):
        t = self.t
        V0 = self.v0(i)
        U, V, d, iters, ok = self.c.scca(
            torch.as_tensor(sd_standardized(self.Y)), torch.as_tensor(V0),
            self.lam1, t["lambda2"], t["maxiter"], t["tol"],
            dtype=torch.float32, tf32=True)
        return SimpleNamespace(U=U, V=V, d=d, n_iters=np.array(iters),
                               converged=ok, V0=V0)

    def judge(self, jobs: list, limits: dict) -> dict:
        """The start of each fit against the reference's draw, and one
        float64 iteration from each fit's (U, V): how far u and v move
        and how far d is from (X u)^T (Y v) (one decode pass for every
        fit)."""
        c = self.c
        Ys = sd_standardized(self.Y)
        V = np.concatenate([j["V"] for j in jobs], axis=1)
        U = np.concatenate([j["U"] for j in jobs], axis=1)
        z, xu = c.cross_and_prod(torch.as_tensor(Ys @ V, device=c.device),
                                 torch.as_tensor(U, device=c.device))
        z, xu = z.cpu(), xu.cpu()
        Ys = torch.as_tensor(Ys)
        nd = self.t["ndim"]
        du = dv = dd = v0 = 0.0
        bad = 0
        for f, job in enumerate(jobs):
            v0 = max(v0, float(np.abs(job["V0"] - self.v0(job["index"]))
                               .max()))
            bad += not (job["converged"] and np.all(job["d"] > 0))
            Uj, Vj = torch.as_tensor(job["U"]), torch.as_tensor(job["V"])
            for j in range(nd):
                col = f * nd + j
                u1 = reference.norm_thresh(
                    reference.gram_schmidt(z[:, col], Uj, j), self.lam1)
                v1 = reference.norm_thresh(
                    reference.gram_schmidt(Ys.T @ xu[:, col], Vj, j),
                    self.t["lambda2"])
                d1 = float(xu[:, col] @ (Ys @ Vj[:, j]))
                du = max(du, float((u1 - Uj[:, j]).abs().max()))
                dv = max(dv, float((v1 - Vj[:, j]).abs().max()))
                dd = max(dd, float(abs(d1 - job["d"][j]))
                         / max(abs(d1), 1e-300))
        return {"v0": (v0, 0.0), "fixed_du": (du, limits.get("fixed_du")),
                "fixed_dv": (dv, limits.get("fixed_dv")),
                "d_rel": (dd, limits.get("d_rel")),
                "not_converged": (float(bad), 0)}


def phenotypes(t: dict, cohort) -> np.ndarray:
    """(n, n_pheno) phenotypes of the cohort, drawn from the traffic's
    ``pheno_seed`` in the cohort's own order and carried into the
    order the run's seed drew; X u* from the reference's own decode."""
    c = cohort
    rng = np.random.default_rng(t["pheno_seed"])
    Y = rng.standard_normal((c.n, t["n_pheno"]))[c.sample_index]
    position = np.argsort(c.snp_index)          # cohort SNP -> position
    for j in range(t["ndim"]):
        idx = position[rng.choice(c.p, size=t["planted"], replace=False)]
        w = rng.normal(size=t["planted"])
        w /= np.linalg.norm(w)
        xu = c.rows_product(
            idx, torch.as_tensor(w, device=c.device)).cpu().numpy()
        Y[:, j] += xu * (t["effect"] / xu.std())
    return Y


def sd_standardized(Y: np.ndarray) -> np.ndarray:
    """Columns centred and divided by their sd (n - 1 denominator)."""
    return (Y - Y.mean(axis=0)) / Y.std(axis=0, ddof=1)
