"""Shared small helpers for the analysis models."""

from __future__ import annotations


def resolve_divisor(divisor: str, n: int, p: int) -> float:
    """Eigenvalue divisor (flashpca.cpp:484-500): 'p' (default), 'n1'
    (n - 1), or 'none' (1)."""
    if divisor == "p":
        return float(p)
    if divisor == "n1":
        return float(n - 1)
    if divisor == "none":
        return 1.0
    raise ValueError(f"unknown divisor: {divisor}")


def note_unsharded(mesh, what: str) -> None:
    """Say that a dense-matrix path ignores a ``mesh`` (it has no sharded
    implementation), as the JAX package does."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        from ..utils.logging import log

        log(f"note: the dense-matrix {what} path runs unsharded; mesh= is "
            "ignored (use the packed path for SNP sharding)")


def matrix_operator(X, stand: str, dtype, device, mesh=None,
                    who: str = "check"):
    """A numeric (N, p) matrix standardized on the host in float64 (as
    the JAX package does) and held by a DenseOperator on the resolved
    device, in float64 unless ``dtype`` says otherwise.  The device is
    resolved first, so that a missing GPU fails before the
    standardization.  A ``mesh`` is noted and not used."""
    import numpy as np
    import torch

    from ..ops.operator import DenseOperator
    from ..ops.standardize import standardize
    from ..utils.device import resolve_device

    device = resolve_device(device)
    note_unsharded(mesh, who)
    X_std, _, _ = standardize(np.asarray(X, dtype=np.float64), stand)
    return DenseOperator(torch.from_numpy(X_std),
                         dtype=dtype or torch.float64, device=device)
