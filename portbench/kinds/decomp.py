"""``pca`` + ``check`` jobs, the reference's ``--check`` run.

Job ``i`` is ``pca(op, ndim)`` from start seed ``i + 1`` (so no job's
answer can be an earlier job's), then ``check()`` of its result.  The
traffic gives ``ndim`` and ``polish``; ``control`` runs the program's
own lower-precision path instead (plain float32 polish and check).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference

# check()'s gap is taken relative to the statistic or, where that is
# below it, to a hundredth of the --check contract's 1e-8
MSE_FLOOR = 1e-10


class Kind:
    def __init__(self, traffic: dict, cohort, control=False):
        self.t = traffic
        self.c = cohort
        self.polish = "fast" if control else traffic["polish"]
        self.precision = "f32" if control else "auto"

    def run(self, i: int, rec) -> dict:
        from flashpca_tpu_torch import check, pca

        c = self.c
        with rec.entry("pca") as t_pca:
            res = pca(c.op, self.t["ndim"], seed=i + 1, polish=self.polish)
        with rec.entry("check") as t_chk:
            chk = check(c.wide, res.vectors, res.values,
                        precision=self.precision)
        return {"index": i, "pca_s": t_pca["seconds"],
                "check_s": t_chk["seconds"], "n_ops": res.n_ops,
                "n_restarts": res.n_restarts, "gate_mse": res.gate_mse,
                "converged": bool(res.converged), "mse": chk.mse,
                "U": res.vectors, "d": res.values}

    def judge(self, jobs: list, limits: dict) -> dict:
        """{number: (reading, limit or None: read, not compared)}.
        Every job's float64 check statistic (one decode pass for all),
        and the gap of the one check() reported to the statistic of the
        vectors it checked: check() rounds U to float32 first, which on
        the tall path, whose U is formed in float64, moves the statistic
        by ~4e-6 of itself whatever check()'s own arithmetic does."""
        c = self.c
        k = self.t["ndim"]
        U = np.concatenate([j["U"] for j in jobs], axis=1)
        U = torch.as_tensor(np.concatenate(
            [U, U.astype(np.float32).astype(np.float64)], axis=1),
            device=c.device)
        d = np.concatenate([j["d"] for j in jobs] * 2)
        err = reference.residual_err(c.gram_columns(U), U, d, float(c.p))
        mse, mse32 = (e.reshape(len(jobs), k).sum(axis=1) / (c.n * k)
                      for e in np.split(err, 2))
        gap = np.array([abs(j["mse"] - m) / max(m, MSE_FLOOR)
                        for j, m in zip(jobs, mse32)])
        ok = np.array([j["converged"] and np.isfinite(j["U"]).all()
                       for j in jobs])
        return {"mse_f64": (float(mse.max()), limits.get("mse_f64")),
                "check_gap": (float(gap.max()), limits.get("check_gap")),
                "not_converged": (float((~ok).sum()), 0)}
