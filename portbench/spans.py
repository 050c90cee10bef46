"""The benchmark's own spans around calls into the program.

In a traced run the benchmark wraps the product methods of the operator
instance it hands to an entry point, from outside the program: each
call gets a ``record_function`` span, named by the method, and a record
of the work its shapes need (roofline.py, by the cohort's table).  A product called from inside
another wrapped product (``crossprod`` runs ``_cross_p``) is counted
once, by the outer one.  Around each job the benchmark opens a span per
entry point (``portbench/pca``, ``portbench/check``, ``portbench/scca``).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass

import torch

from . import roofline

PREFIX = "portbench/"


@dataclass
class Call:
    span: str          # the record_function name, unique in the run
    method: str
    group: str         # the cohort table's group of the product
    kc: int
    flops: float
    nbytes: float


class Recorder:
    """Spans and product records of one run; inert unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.calls: list[Call] = []
        self._ids = itertools.count()
        self._inside = False

    def wrap(self, op, table) -> None:
        """Wrap the products of ``table`` (a cohort's ``products``) that
        ``op`` has in spans."""
        if not self.on:
            return
        n, p = op.n_samples, op.n_snps
        # the solver's panels live in the operator's own space
        size = {"space": op.op_dim, "n": n, "p": p}
        for name, (group, products, dots, halves, src, dst) in \
                table.items():
            if hasattr(op, name):
                work = (n, p, products, dots, halves, size[src], size[dst])
                setattr(op, name, self._wrapped(
                    name, group, getattr(op, name), work))

    def _wrapped(self, name, group, fn, work):
        n, p, products, dots, halves, src, dst = work

        def call(x, *args, **kwargs):
            if self._inside:
                return fn(x, *args, **kwargs)
            kc = 1 if x.ndim == 1 else int(x.shape[1])
            flops, nbytes = roofline.product_work(n, p, kc, products, dots,
                                                  halves, src, dst)
            span = f"{PREFIX}{name}#{next(self._ids)}"
            self._inside = True
            try:
                with torch.profiler.record_function(span):
                    out = fn(x, *args, **kwargs)
            finally:
                self._inside = False
            self.calls.append(Call(span, name, group, kc, flops, nbytes))
            return out
        return call

    @contextlib.contextmanager
    def entry(self, name: str):
        """Host-clock span around one entry-point call, ending in a
        synchronize; yields a dict that holds ``seconds`` afterwards."""
        out = {}
        span = f"{PREFIX}{name}#{next(self._ids)}"
        _sync()
        t0 = time.perf_counter()
        with (torch.profiler.record_function(span) if self.on
              else contextlib.nullcontext()):
            yield out
            _sync()
        out["seconds"] = time.perf_counter() - t0


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
