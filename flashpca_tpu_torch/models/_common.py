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


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported option raises, naming the ROADMAP
    item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})")
