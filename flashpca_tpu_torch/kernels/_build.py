"""Build and load the hand-written Hopper kernels (kernels/csrc/*.cu).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``; a source may hold several
kernels (matvec_ff.cu holds the first designs of B4 and B5), each with
its own C entry.  Twenty-four entries in sixteen libraries: B1-B5, B1
and B2 at one column (``crossprod_narrow``, ``matvec_narrow``), the
sweep's tile entries of B1 and B2 and its variants V1-V4 (V1, V2 and V4
in crossprod_variants_v2.cu, their first designs ``crossprod_stacked_v1``,
``crossprod_intsub_v1`` and ``crossprod_nocomp_v1`` in
crossprod_variants.cu; V3 in crossprod_split3_v2.cu, its first design
``crossprod_split3_v1`` in crossprod_split3.cu), B1's first design
(``crossprod_v1``, in crossprod.cu beside the sweep's B1 tile entry), B2's
first design (``matvec_v1``, in matvec.cu beside the sweep's B2 tile
entry), B3's first design (``crossprod_ff_v1``, in crossprod_ff.cu), B4's
first design (``matvec_ff_v1``, in matvec_ff.cu) and B5's comparison
entries -- its first design (``matvec_ff_novl_v1``, in matvec_ff.cu) and
two other tiles (``matvec_ff_novl_c4``, ``matvec_ff_novl_cr128``).
The build happens at first use, never at import (the CPU tests import
every module, and the CPU has no ``nvcc``), into
``kernels/build/<hash>/`` -- a directory that ``.gitignore`` lists.  The
hash covers every source, header and flag, so an edited source builds
anew; the sources compile in parallel, one ``nvcc`` each.

The flags target ``sm_90a`` (Hopper) and deliberately leave out
``--use_fast_math``: the compensated accumulation relies on IEEE
round-to-nearest float addition.  ``kernel_name`` and ``ptxas_usage``
read the compiler's register report that ``build_all`` keeps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
HEADERS = ("common.cuh", "b1_tile.cuh")

# kernel name -> (source, C entry point, argument types)
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
KERNELS = {
    "crossprod": ("crossprod_v2.cu", "fp_crossprod",
                  [_P] * 6 + [_I64, _I64, _I32, _P]),
    "matvec": ("matvec_v2.cu", "fp_matvec",
               [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_ff": ("crossprod_ff_v2.cu", "fp_crossprod_ff",
                     [_P] * 5 + [_I64, _I64, _I32, _P]),
    "matvec_ff": ("matvec_ff_v2.cu", "fp_matvec_ff",
                  [_P] * 6 + [_I64, _I64, _I32, _P]),
    "matvec_ff_novl": ("matvec_ff_novl.cu", "fp_matvec_ff_novl",
                       [_P] * 5 + [_I64, _I64, _I32, _P]),
    # B1 and B2 at one column (kc 1): what the operators launch for a
    # one-column chunk
    "crossprod_narrow": ("crossprod_narrow.cu", "fp_crossprod_narrow",
                         [_P] * 6 + [_I64, _I64, _I32, _P]),
    "matvec_narrow": ("matvec_narrow.cu", "fp_matvec_narrow",
                      [_P] * 6 + [_I64, _I64, _I32, _P]),
    # B1's first design: timed beside production B1, launched by no
    # operator
    "crossprod_v1": ("crossprod.cu", "fp_crossprod_v1",
                     [_P] * 6 + [_I64, _I64, _I32, _P]),
    # B2's first design: timed beside production B2, launched by no
    # operator
    "matvec_v1": ("matvec.cu", "fp_matvec_v1",
                  [_P] * 6 + [_I64, _I64, _I32, _P]),
    # B3's first design: timed beside production B3, launched by no
    # operator
    "crossprod_ff_v1": ("crossprod_ff.cu", "fp_crossprod_ff_v1",
                        [_P] * 5 + [_I64, _I64, _I32, _P]),
    # B4's first design: timed beside production B4, launched by no
    # operator
    "matvec_ff_v1": ("matvec_ff.cu", "fp_matvec_ff_v1",
                     [_P] * 6 + [_I64, _I64, _I32, _P]),
    # B5's first design and B5 at two other tiles: timed beside
    # production B5, launched by no operator
    "matvec_ff_novl_v1": ("matvec_ff.cu", "fp_matvec_ff_novl_v1",
                          [_P] * 5 + [_I64, _I64, _I32, _P]),
    "matvec_ff_novl_c4": ("matvec_ff_novl_variants.cu",
                          "fp_matvec_ff_novl_c4",
                          [_P] * 5 + [_I64, _I64, _I32, _P]),
    "matvec_ff_novl_cr128": ("matvec_ff_novl_variants.cu",
                             "fp_matvec_ff_novl_cr128",
                             [_P] * 5 + [_I64, _I64, _I32, _P]),
    # the kernel sweep (tools/kernel_sweep.py): B1/B2 at another tile
    # (tm / cr before kc) and the measurement variants V1-V4 of B1
    "crossprod_tiled": ("crossprod.cu", "fp_crossprod_tiled",
                        [_P] * 6 + [_I64, _I64, _I32, _I32, _P]),
    "matvec_tiled": ("matvec.cu", "fp_matvec_tiled",
                     [_P] * 6 + [_I64, _I64, _I32, _I32, _P]),
    "crossprod_stacked": ("crossprod_variants_v2.cu", "fp_crossprod_stacked",
                          [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_intsub": ("crossprod_variants_v2.cu", "fp_crossprod_intsub",
                         [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_nocomp": ("crossprod_variants_v2.cu", "fp_crossprod_nocomp",
                         [_P] * 6 + [_I64, _I64, _I32, _P]),
    # V3 takes B1's arguments and, after x, its pre-split panel (scratch)
    "crossprod_split3": ("crossprod_split3_v2.cu", "fp_crossprod_split3",
                         [_P] * 7 + [_I64, _I64, _I32, _P]),
    # V1's, V2's, V4's and V3's first designs: timed beside their
    # redesigns by the sweep, launched by no operator
    "crossprod_stacked_v1": ("crossprod_variants.cu",
                             "fp_crossprod_stacked_v1",
                             [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_intsub_v1": ("crossprod_variants.cu", "fp_crossprod_intsub_v1",
                            [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_nocomp_v1": ("crossprod_variants.cu", "fp_crossprod_nocomp_v1",
                            [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_split3_v1": ("crossprod_split3.cu", "fp_crossprod_split3_v1",
                            [_P] * 6 + [_I64, _I64, _I32, _P]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_funcs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels need the CUDA toolkit to build")
    return path


def sources() -> list[str]:
    """The distinct sources, one shared library each."""
    return sorted({src for src, _, _ in KERNELS.values()})


def _lib_stem(src: str) -> str:
    return os.path.splitext(src)[0]


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources() + list(HEADERS):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> str:
    """Compile every kernel library that is not built yet (all ``nvcc``
    processes started together) and return the build directory.  The
    compiler's register/shared-memory report (``-Xptxas -v``) is kept
    beside each library as ``<source stem>.log``."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = None
    procs = []
    for src in sources():
        name = _lib_stem(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        msgs = []
        for name in failed:
            with open(os.path.join(out_dir, f"{name}.log")) as fh:
                msgs.append(f"--- {name} ---\n{fh.read()[-4000:]}")
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(msgs))
    return out_dir


def kernel(name: str):
    """The ctypes entry point of kernel ``name`` (built on first use).
    Every entry returns ``cudaGetLastError()`` as an int."""
    fn = _funcs.get(name)
    if fn is None:
        with _lock:
            if not _funcs:
                out_dir = build_all()
                libs = {src: ctypes.CDLL(os.path.join(
                            out_dir, f"lib{_lib_stem(src)}.so"))
                        for src in sources()}
                for kname, (src, sym, argtypes) in KERNELS.items():
                    f = getattr(libs[src], sym)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _funcs[kname] = f
        fn = _funcs[name]
    return fn


def kernel_name(text):
    """"kernel<template args>" of the first mangled ``..._kernel<...>``
    symbol in ``text`` (template arguments in order: kc, then TM / CR /
    HAS_VL / C), or None."""
    m = re.search(r"\w*?\d([a-z_]+_kernel)I((?:L[a-z]\d+E)+)E", text)
    if not m:
        return None
    targs = re.findall(r"L[a-z](\d+)E", m.group(2))
    return f"{m.group(1)}<{', '.join(targs)}>"


def ptxas_usage(lines):
    """(kernel<template args>, "Used N registers, ...; S bytes spill
    stores, L bytes spill loads") for each instantiation in an ``nvcc
    -Xptxas -v`` log: registers, shared memory and spills."""
    fn, spills = "?", ""
    for line in lines:
        name = "Compiling entry function" in line and kernel_name(line)
        if name:
            fn, spills = name, ""
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)",
                      line)
        if m:
            spills = f"; {m.group(1)}"
        m = re.search(r"(Used \d+ registers.*)", line)
        if m:
            yield fn, m.group(1).strip() + spills
