"""ctypes binding for the native .bed decode kernels (csrc/bedio.cpp).

Loads ``csrc/libbedio.so`` if it has been built (``make -C csrc``);
every entry point has a numpy fallback in io/plink.py, so the native
library is an accelerator, never a requirement.  The native kernels
are single-pass LUT loops, OpenMP-parallel over SNPs -- the analog of
the reference's C++ decode layer (data.cpp:65-148, 215-335).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))
    cand = os.path.join(here, "..", "..", "csrc", "libbedio.so")
    return cand if os.path.exists(cand) else None


def load() -> ctypes.CDLL | None:
    """Load (once) and return the native library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f8p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.bed_stats.argtypes = [u8p, i64, i64, i64, ctypes.c_int, f8p, f8p]
    lib.bed_stats.restype = None
    lib.bed_standardize.argtypes = [u8p, i64, i64, i64, f8p, f8p,
                                    ctypes.c_double, f8p]
    lib.bed_standardize.restype = None
    lib.bed_dosage.argtypes = [u8p, i64, i64, i64, f8p]
    lib.bed_dosage.restype = None
    lib.bed_codes.argtypes = [u8p, i64, i64, i64,
                              np.ctypeslib.ndpointer(np.uint8,
                                                     flags="C_CONTIGUOUS")]
    lib.bed_codes.restype = None
    if hasattr(lib, "bed_set_num_threads"):  # absent in older builds
        lib.bed_set_num_threads.argtypes = [ctypes.c_int]
        lib.bed_set_num_threads.restype = None
    if hasattr(lib, "bed_moments"):  # absent in older builds
        lib.bed_moments.argtypes = [u8p, i64, i64, i64, f8p, f8p, f8p]
        lib.bed_moments.restype = None
    _LIB = lib
    return lib


def set_num_threads(n: int) -> None:
    """Set the native kernels' OpenMP thread count (CLI --numthreads;
    the reference's omp_set_num_threads wiring, flashpca.cpp:571-577).
    No-op if the native library is absent or predates the export."""
    lib = load()
    if lib is not None and hasattr(lib, "bed_set_num_threads"):
        lib.bed_set_num_threads(int(n))


def available() -> bool:
    return load() is not None


def stats(packed: np.ndarray, n_samples: int, method: str):
    """Per-SNP (mean, sd); method 'binom' or 'binom2'."""
    if method not in ("binom", "binom2"):
        # the numpy twin raises here too -- a typo must not silently
        # become binom2
        raise ValueError(f"unknown standardisation method: {method}")
    lib = load()
    assert lib is not None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, nbytes = packed.shape
    mean = np.empty(p, dtype=np.float64)
    sd = np.empty(p, dtype=np.float64)
    lib.bed_stats(packed, p, nbytes, n_samples,
                  1 if method == "binom" else 2, mean, sd)
    return mean, sd


def moments_available() -> bool:
    """True when the built library exports ``bed_moments`` (older .so
    builds predate it; callers fall back to the numpy moments path)."""
    lib = load()
    return lib is not None and hasattr(lib, "bed_moments")


def moments(packed: np.ndarray, n_samples: int):
    """Per-SNP raw dosage moments (ngood, dsum, d2sum), float64."""
    lib = load()
    assert lib is not None and hasattr(lib, "bed_moments")
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, nbytes = packed.shape
    ngood = np.empty(p, dtype=np.float64)
    dsum = np.empty(p, dtype=np.float64)
    d2sum = np.empty(p, dtype=np.float64)
    lib.bed_moments(packed, p, nbytes, n_samples, ngood, dsum, d2sum)
    return ngood, dsum, d2sum


def standardize(packed: np.ndarray, n_samples: int, mean: np.ndarray,
                sd: np.ndarray, var_tol: float) -> np.ndarray:
    """Standardized (p, N) float64 matrix, streaming-path semantics.

    NOTE: host-decode utility with KERNEL semantics -- columns at
    sd <= var_tol are ZEROED (like the device decode), which
    deliberately differs from ops/standardize.standardize's C++
    set-to-mean rule.  No production caller today (the operators
    standardize on device); kept as the tested native twin of
    dense_standardized_np."""
    lib = load()
    assert lib is not None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, nbytes = packed.shape
    out = np.empty((p, n_samples), dtype=np.float64)
    lib.bed_standardize(packed, p, nbytes, n_samples,
                        np.ascontiguousarray(mean, dtype=np.float64),
                        np.ascontiguousarray(sd, dtype=np.float64),
                        var_tol, out)
    return out


def dosage(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """(p, N) float64 dosage with NaN for missing."""
    lib = load()
    assert lib is not None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, nbytes = packed.shape
    out = np.empty((p, n_samples), dtype=np.float64)
    lib.bed_dosage(packed, p, nbytes, n_samples, out)
    return out


def codes(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """(p, N) uint8 2-bit codes."""
    lib = load()
    assert lib is not None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, nbytes = packed.shape
    out = np.empty((p, n_samples), dtype=np.uint8)
    lib.bed_codes(packed, p, nbytes, n_samples, out)
    return out
