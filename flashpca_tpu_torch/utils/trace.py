"""Named host spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` called
``flashpca/<name>`` while a profiler is recording, and one shared no-op
context otherwise: with no profiler running a span allocates nothing and
makes no dispatcher call.  ``kc=`` appends the panel width to the name
(``flashpca/op/gram@16``): the Chrome trace keeps a span's name but not
``record_function``'s ``args``.  The spans are host events on the
profiler's clock, the clock of its CUDA activity too, so a stretch in
which the card ran nothing can be set against the spans the host was in.
The profiler keeps them and writes them with its trace (the CLI's
``--profile DIR``); this module writes nothing.

Nesting is by call: a span's parent is the span that encloses it on its
thread.  The tree of one ``pca()``, ``check()`` and ``scca()``:

=====================  ===================================================
span                   covers
=====================  ===================================================
``pca``                the whole ``pca()`` call
``pca/start``          the start vector's draw and permutation
``lanczos/solve``      one thick-restart block Lanczos solve (the capped
                       one; a fallback's is a second)
``lanczos/start``      the start panel, up to the first product
``lanczos/draw``       its seeded host draw and float64 upload
``lanczos/orth``       its QR on the device, the basis' allocation and
                       the cast into it
``lanczos/cycle``      one thick-restart cycle
``lanczos/step``       one panel: product, CGS2, panel orthonormalization
                       and its deflation test's sync
``lanczos/ritz``       the projected blocks' transfer, T's assembly and
                       eigendecomposition, the convergence test, the
                       restart rotation (and, after the last cycle, the
                       Ritz vectors' rotation)
``polish/sweep``       one float32 subspace sweep
``polish/refine``      one compensated refinement: its two-float passes
                       and rounds
``polish/ritz``        a host Rayleigh-Ritz of the polish: the residual
                       panel's Gram and its eigendecomposition, the
                       generalized solve (the plain polish's final one)
``pca/fallback``       the adaptive re-solve, when the contract gate misses
``pca/finish``         unpermute, the tall path's U = X V, the transfer to
                       the host, projection and loadings
``check``              the whole ``check()`` call
``check/upload``       the vectors to the device and their cast
``check/residual``     the residual sums and their transfer
``scca``               the whole ``scca()`` call
``scca/setup``         Y's scaling, the operator, V0, the engine's state
``scca/dim``           one dimension of the device engine
``scca/iter``          one iteration, with the loop test's sync
``scca/dim_end``       d and the dimension's one packed transfer
``scca/result``        the projections Px and Py
``op/<product>@<kc>``  one operator product (``gram``, ``gram_ff``,
                       ``cross``, ``prod``) on a kc-column panel
``mesh/scatter@<kc>``  a sharded resident wide product's operands copied
                       to its shards' devices (inside ``op/*``)
``mesh/gather@<kc>``   its shards' partials copied to the home device,
                       before they are summed (inside ``op/*``)
=====================  ===================================================
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "flashpca/"

_OFF = contextlib.nullcontext()


def span(name: str, kc: int | None = None):
    """A ``flashpca/<name>[@kc]`` span while a profiler records, else a
    shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    full = PREFIX + name if kc is None else f"{PREFIX}{name}@{kc}"
    return torch.profiler.record_function(full)


def traced(name: str):
    """Decorator: the whole call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def width(x) -> int:
    """A product's panel width: 1 for a vector, else its columns."""
    return 1 if x.ndim == 1 else int(x.shape[1])
