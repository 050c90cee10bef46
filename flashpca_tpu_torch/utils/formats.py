"""Numeric text formatting matching the reference's output files.

The reference writes all text output through Eigen IOFormat with
``std::setprecision(precision)`` and default float notation
(reference: util.h:69-108, default precision 7 at flashpca.cpp:554),
which is equivalent to C's ``%.{precision}g``.
"""

from __future__ import annotations


def format_g(value: float, precision: int = 7) -> str:
    """Format a float the way a C++ ostream with setprecision(p) does."""
    return f"{float(value):.{int(precision)}g}"
