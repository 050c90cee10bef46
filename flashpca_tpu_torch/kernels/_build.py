"""Build and load the hand-written Hopper kernels (kernels/csrc/*.cu).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``; a source may hold several
kernels (matvec_ff.cu holds B4 and B5), each with its own C entry.  The
build happens at first use, never at import (the CPU tests import every
module, and the CPU has no ``nvcc``), into ``kernels/build/<hash>/`` -- a directory that
``.gitignore`` lists.  The hash covers every source, header and flag,
so an edited source builds anew; the sources compile in parallel, one
``nvcc`` each.

The flags target ``sm_90a`` (Hopper) and deliberately leave out
``--use_fast_math``: the compensated accumulation relies on IEEE
round-to-nearest float addition.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
HEADERS = ("common.cuh",)

# kernel name -> (source, C entry point, argument types)
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
KERNELS = {
    "crossprod": ("crossprod.cu", "fp_crossprod",
                  [_P] * 6 + [_I64, _I64, _I32, _P]),
    "matvec": ("matvec.cu", "fp_matvec",
               [_P] * 6 + [_I64, _I64, _I32, _P]),
    "crossprod_ff": ("crossprod_ff.cu", "fp_crossprod_ff",
                     [_P] * 5 + [_I64, _I64, _I32, _P]),
    "matvec_ff": ("matvec_ff.cu", "fp_matvec_ff",
                  [_P] * 6 + [_I64, _I64, _I32, _P]),
    "matvec_ff_novl": ("matvec_ff.cu", "fp_matvec_ff_novl",
                       [_P] * 5 + [_I64, _I64, _I32, _P]),
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
