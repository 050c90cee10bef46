"""Decomposition accuracy checking (--check mode).

Equivalent of ``RandomPCA::check`` (reference: randompca.cpp:627-743):
per-component squared error of ``(X X^T U)/div - U diag(d)``, plus
``mse = sum(err)/(N*K)`` and ``rmse = sqrt(mse)``.

The error reduction runs on the operator's device and fetches only the
(K,) per-component sums.  ``data`` may be a PLINK root /
:class:`PlinkDataset`, a prebuilt :class:`PackedOperator`,
:class:`StreamingPackedOperator` or :class:`DenseOperator`, or a numeric
(N, p) matrix, standardized on the host and checked through a
:class:`DenseOperator` on the requested device (``None`` -> ``cuda``,
which raises without a GPU), in float64 unless ``dtype`` says otherwise;
``evec`` may be a numpy array or a device tensor.  ``mesh=`` shards the
packed operator (parallel/dist.py); a matrix is checked unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.plink import PlinkDataset
from ..ops.operator import (TALL_OPERATORS, WIDE_OPERATORS,
                            build_packed_operator, check_operator_conflicts)
from ..utils.trace import span, traced
from ._common import matrix_operator
from ._common import resolve_divisor as _div


@dataclass
class CheckResult:
    err: np.ndarray  # (K,) per-component sum squared error
    mse: float
    rmse: float


@traced("check")
def check(data, evec, eval_, *, stand: str | None = None,
          divisor: str = "p", block_size: int | None = None, dtype=None,
          device=None, mesh=None, streaming="auto",
          memory_mb: int | None = None,
          precision: str = "auto") -> CheckResult:
    """Check eigenvectors/eigenvalues against the data.

    ``evec``: (N, K) eigenvectors U.  ``eval_``: (K,) eigenvalues d
    (already divided by div, as written in eigenvalues.txt).

    ``precision``: 'auto' (default) measures a float32 operator's
    residual with the COMPENSATED two-float product (the float64-grade
    measurement of the reference, randompca.cpp:684-697; plain float32
    accumulation noise floors the reported mse near 1e-8 at biobank
    scale whatever the eigenpairs); 'f32' forces the plain product;
    'compensated' requires the two-float path.  The plain path forms the
    residual in float64.
    """
    if precision not in ("auto", "f32", "compensated"):
        raise ValueError(f"unknown precision: {precision!r}")
    eval_np = np.asarray(eval_, dtype=np.float64).reshape(-1)
    if not isinstance(evec, torch.Tensor):
        evec = np.asarray(evec, dtype=np.float64)
    if evec.ndim == 1:
        evec = evec[:, None]            # a single component is a column

    if isinstance(data, str):
        data = PlinkDataset.open(data)
    if isinstance(data, TALL_OPERATORS):
        raise ValueError(
            "check() verifies the WIDE decomposition X X^T U = U d "
            "(randompca.cpp:663-703); a tall operator exposes X^T X -- "
            "pass the PLINK data (or a wide operator) instead")
    matrix = not isinstance(data, (PlinkDataset, *WIDE_OPERATORS))
    if matrix:
        data = matrix_operator(data, stand or "binom2", dtype, device,
                               mesh=mesh)
    elif stand is not None and isinstance(data, WIDE_OPERATORS):
        raise ValueError(
            "stand= was passed with a prebuilt operator, whose "
            "standardization is baked in; rebuild the operator with the "
            "desired stats")
    stand = stand or "binom2"

    # validate BEFORE the stats pass / operator build
    if evec.shape[0] != data.n_samples:
        raise ValueError(
            "Eigenvector dimension doesn't match data dimension "
            f"(evec.rows = {evec.shape[0]}; N = {data.n_samples})")
    if eval_np.shape[0] != evec.shape[1]:
        raise ValueError(
            "Eigenvector dimension doesn't match the number of eigenvalues")
    _div(divisor, data.n_samples, data.n_snps)

    if matrix:
        op = data
    elif isinstance(data, WIDE_OPERATORS):
        check_operator_conflicts(data, dtype=dtype, streaming=streaming,
                                 memory_mb=memory_mb, block_size=block_size,
                                 device=device, mesh=mesh)
        op = data
    else:
        mean, sd = data.snp_stats(stand)
        op = build_packed_operator(
            data, mean, sd, streaming=streaming, memory_mb=memory_mb,
            block_size=block_size, dtype=dtype, device=device, mesh=mesh)

    n, p = op.n_samples, op.n_snps
    K = min(evec.shape[1], eval_np.shape[0])
    div = _div(divisor, n, p)
    use_ff = op.dtype == torch.float32 and precision in ("auto",
                                                         "compensated")
    if precision == "compensated" and not use_ff:
        raise ValueError(
            "precision='compensated' needs a float32 operator (the "
            "two-float product path)")
    with span("check/upload"):
        U = torch.as_tensor(evec, device=op.device)
        Uop = (U[:, :K].to(torch.float32).contiguous() if use_ff
               else U.to(op.dtype))
    if use_ff:
        from ..ops.compensated import residual_sums_ff

        hi, lo = op.perform_op_ff(Uop)
        # residual measured UNdivided -- (X X^T U) - U * (d * div) in
        # two-float arithmetic -- then rescaled exactly on the host
        with span("check/residual"):
            err = residual_sums_ff(hi, lo, Uop, eval_np[:K] * div)
            err = err / (float(div) * float(div))
    else:
        XXU = op.perform_op(Uop)
        # the residual is a near-cancelling subtraction of two O(d)
        # quantities: form it in float64 from the caller's vectors
        with span("check/residual"):
            Ur = U.to(torch.float64)
            D = torch.as_tensor(eval_np[:K], device=op.device)
            R = (XXU[:, :K].to(torch.float64) * (1.0 / div)
                 - Ur[:, :K] * D[None, :])
            err = (R * R).sum(dim=0).to("cpu").numpy()
    mse = float(err.sum() / (n * K))
    return CheckResult(err=err, mse=mse, rmse=float(np.sqrt(mse)))

