"""The kernel sweep's kernels: B1 and B2 at another tile, and the four
measurement variants of B1, with their plain PyTorch versions.

====  ==========================  ======================================
V1    crossprod_variants_v2.cu    B1 with the decoded planes stacked into
                                  one contraction per chunk (``stacked``)
V2    crossprod_variants_v2.cu    B1 decoding u = code - 1 in int with the
                                  g-coefficients (``intsub``)
V3    crossprod_split3_v2.cu      B1 with each product as three bf16
                                  tensor-core products (``split3``)
V4    crossprod_variants_v2.cu    B1 without the TwoSum compensation
                                  (``nocomp``)
--    crossprod.cu / matvec.cu    B1 at TM rows per block, B2 at CR SNP
                                  rows per chunk (the sweep's tile axis)
====  ==========================  ======================================

V1, V2 and V4 are redesigns on B1's second design (crossprod_v2.cu), V3 a
redesign of its own on the tensor cores, each bit for bit its first
design, which stays as ``crossprod_stacked_v1_p``,
``crossprod_intsub_v1_p``, ``crossprod_nocomp_v1_p`` (crossprod_variants.cu)
and ``crossprod_split3_v1_p`` (crossprod_split3.cu), in ``FIRST_DESIGNS``;
the sweep times each beside its redesign and B1.  V3's wrapper also
allocates the scratch panel its kernel's pre-pass fills with x split into
bf16 (``split3_scratch``).

The sweep's docstring (.claude/skills/verify/kernel_sweep.py) calls
``nocomp`` V3 and its comment calls ``split3`` V4; the port numbers them
as ROADMAP.md and PERF.md do and names each by its function suffix.

Every wrapper takes permuted ``(n4, k)`` panels like ``crossprod_p``
(``matvec_tiled_p`` an SNP-space ``(p, k)`` panel like ``matvec_p``),
runs its plain version for a CPU tensor, launches its kernel for a CUDA
float32 tensor, or raises: there is no fallback.  Launches count in
``packed_matvec.launch_counts``.  None of these is on ``pca()``'s path;
``tools/kernel_sweep.py`` times them against B1.
"""

from __future__ import annotations

import torch

from ..ops.compensated import twosum
from .packed_matvec import (_byte_chunk, _check_cuda, _check_shapes,
                            _decode_plane_cubic, _padded, _run, _widths,
                            coeff_rows, crossprod_plain, matvec_plain)

TILE_TM = (128, 256, 512)     # B1 rows per block; production 256
TILE_CR = (32, 64, 128)       # B2 SNP rows per chunk; production 64
# packed bytes per chunk of the kernels whose plain versions fold where
# they do: V1 (stacked_kernel's S_CB) and V4 (B1's CB, nocomp_kernel);
# and V3's fold unit, the chunk of its pre-split panel
STACKED_CB = 16
NOCOMP_CB = 32
SPLIT3_CB = 32


# ---------------------------------------------------------------------------
# Per-SNP constants and the bf16 split
# ---------------------------------------------------------------------------

def coeff_rows_intsub(mean, invsd):
    """(g0, g1, g2), float32 (p,) each, of the integer-shifted decode
    w(u) = u (g0 + u (g1 + u g2)), u = code - 1.

    w(u) = (2-m)i, 0, (1-m)i, -mi at u = -1, 0, 1, 2, so q(u) = w(u) / u
    is (m-2)i, (1-m)i, -mi/2 at u = -1, 1, 2 and g0 + g1 u + g2 u^2 is
    the quadratic through those three points.  The float32 operations
    are those of the sweep's ``_coeff_rows_intsub``, in its order."""
    m = mean.to(torch.float32)
    i = invsd.to(torch.float32)
    qm1 = (m - 2.0) * i
    q1 = (1.0 - m) * i
    q2 = -0.5 * m * i
    g2 = (qm1 / 6.0) - (q1 / 2.0) + (q2 / 3.0)
    g1 = (q1 - qm1) / 2.0
    g0 = q1 - g1 - g2
    return g0.contiguous(), g1.contiguous(), g2.contiguous()


def split_bf16(a):
    """(hi, lo) bf16 with hi = rn(a), lo = rn(a - hi), round to nearest
    even at both steps: hi + lo carries a float32 value to ~2^-16."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _decode_plane_intsub(blk, s, g0, g1, g2):
    u = (((blk >> (2 * s)) & 3).to(torch.int32) - 1).to(torch.float32)
    return u * (g0[:, None] + u * (g1[:, None] + u * g2[:, None]))


# ---------------------------------------------------------------------------
# Plain versions: each variant's decode, contraction and fold, over byte
# chunks -- those of crossprod_plain, or the kernel's own where the
# result depends on them (V1's one contraction per chunk, V4's plain
# fold)
# ---------------------------------------------------------------------------

def _chunked(packed, xp, partial, compensate=True, cb=None):
    """z = sum over byte chunks (``cb`` bytes, by default
    crossprod_plain's) of ``partial(blk, x[:, chunk])``, each a float32
    (p, k) partial, folded in with TwoSum -- or, with
    ``compensate=False``, added plainly."""
    p, nb = packed.shape
    k = xp.shape[1]
    x = xp.to(torch.float32).reshape(4, nb, k)
    z = torch.zeros((p, k), dtype=torch.float32, device=xp.device)
    err = torch.zeros_like(z)
    cb = cb or _byte_chunk(p)
    for c0 in range(0, nb, cb):
        t = partial(packed[:, c0: c0 + cb], x[:, c0: c0 + cb])
        if compensate:
            z, e = twosum(z, t)
            err = err + e
        else:
            z = z + t
    return z + err


def crossprod_stacked_plain(packed, mean, invsd, xp):
    """V1's z = W xp: per STACKED_CB-byte chunk ONE matmul of the four
    decoded planes concatenated along the samples against the matching
    panel rows, TwoSum-folded as the kernel folds."""
    b0, b1, b2 = coeff_rows(mean, invsd)

    def partial(blk, x):
        w = torch.cat([_decode_plane_cubic(blk, s, b0, b1, b2)
                       for s in range(4)], dim=1)
        return w @ x.reshape(-1, x.shape[-1])

    return _chunked(packed, xp, partial, cb=STACKED_CB)


def crossprod_intsub_plain(packed, mean, invsd, xp):
    """V2's z = W xp, decoded as u (g0 + u (g1 + u g2)), u = code - 1."""
    g = coeff_rows_intsub(mean, invsd)

    def partial(blk, x):
        t = 0.0
        for s in range(4):
            t = t + _decode_plane_intsub(blk, s, *g) @ x[s]
        return t

    return _chunked(packed, xp, partial)


def crossprod_split3_plain(packed, mean, invsd, xp):
    """V3's z = W xp: each plane's product as wh xh + wh xl + wl xh of
    the bf16 pieces (lo * lo dropped), each piece product exact in
    float32."""
    b0, b1, b2 = coeff_rows(mean, invsd)

    def partial(blk, x):
        t = 0.0
        for s in range(4):
            wh, wl = split_bf16(_decode_plane_cubic(blk, s, b0, b1, b2))
            xh, xl = split_bf16(x[s])
            wh, wl = wh.float(), wl.float()
            xh, xl = xh.float(), xl.float()
            t = t + (wh @ xh + wh @ xl + wl @ xh)
        return t

    return _chunked(packed, xp, partial)


def crossprod_nocomp_plain(packed, mean, invsd, xp):
    """V4's z = W xp: the partials of the kernel's NOCOMP_CB-byte chunks
    added plainly (no TwoSum), as the kernel adds them."""
    b0, b1, b2 = coeff_rows(mean, invsd)

    def partial(blk, x):
        t = 0.0
        for s in range(4):
            t = t + _decode_plane_cubic(blk, s, b0, b1, b2) @ x[s]
        return t

    return _chunked(packed, xp, partial, compensate=False, cb=NOCOMP_CB)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def split3_scratch(nb, kc, device):
    """V3's pre-split panel, which its kernel's pre-pass writes: per
    32-byte chunk of the ``nb`` packed bytes, x's bf16 hi and lo planes
    as [hi/lo][plane][column][32 samples], ``kc`` columns."""
    nchunk = -(-nb // SPLIT3_CB)
    return torch.empty(nchunk * 2 * 4 * kc * SPLIT3_CB, dtype=torch.bfloat16,
                       device=device)


def _launch_over_widths(name, packed, coeffs, xp, rows, *extra):
    """Launch kernel ``name`` once per column chunk of ``xp``; ``rows``
    is the output's row count (p for z, n4 for y)."""
    _check_cuda(packed, xp, *coeffs)
    p, nb = packed.shape
    outs = []
    for c0, c1, kc in _widths(xp.shape[1]):
        out = torch.empty((rows, kc), dtype=torch.float32,
                          device=packed.device)
        _run(name, packed, *coeffs, _padded(xp, c0, c1, kc), out, p, nb,
             *extra, kc)
        outs.append(out[:, : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _variant(name, plain, coeffs_of):
    def wrapper(packed, mean, invsd, xp):
        _check_shapes(4 * packed.shape[1], xp, name)
        if xp.device.type == "cpu":
            return plain(packed, mean, invsd, xp)
        return _launch_over_widths(name, packed, coeffs_of(mean, invsd), xp,
                                   packed.shape[0])

    wrapper.__name__ = f"{name}_p"
    wrapper.__doc__ = (f"z = W xp: (n4, k) -> (p, k).  Kernel ``{name}`` "
                       f"on CUDA, :func:`{plain.__name__}` on the CPU.")
    return wrapper


crossprod_stacked_p = _variant("crossprod_stacked", crossprod_stacked_plain,
                               coeff_rows)
crossprod_intsub_p = _variant("crossprod_intsub", crossprod_intsub_plain,
                              coeff_rows_intsub)
crossprod_nocomp_p = _variant("crossprod_nocomp", crossprod_nocomp_plain,
                              coeff_rows)


def crossprod_split3_p(packed, mean, invsd, xp):
    """z = W xp: (n4, k) -> (p, k).  Kernel ``crossprod_split3`` on CUDA,
    each column chunk with the scratch panel its pre-pass fills
    (:func:`split3_scratch`); :func:`crossprod_split3_plain` on the
    CPU."""
    _check_shapes(4 * packed.shape[1], xp, "crossprod_split3")
    if xp.device.type == "cpu":
        return crossprod_split3_plain(packed, mean, invsd, xp)
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, xp, *coeffs)
    p, nb = packed.shape
    outs = []
    for c0, c1, kc in _widths(xp.shape[1]):
        out = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
        _run("crossprod_split3", packed, *coeffs, _padded(xp, c0, c1, kc),
             split3_scratch(nb, kc, packed.device), out, p, nb, kc)
        outs.append(out[:, : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# the first designs (crossprod_variants.cu, crossprod_split3.cu), the sums
# of the four above bit for bit
crossprod_stacked_v1_p = _variant("crossprod_stacked_v1",
                                  crossprod_stacked_plain, coeff_rows)
crossprod_intsub_v1_p = _variant("crossprod_intsub_v1",
                                 crossprod_intsub_plain, coeff_rows_intsub)
crossprod_nocomp_v1_p = _variant("crossprod_nocomp_v1",
                                 crossprod_nocomp_plain, coeff_rows)
crossprod_split3_v1_p = _variant("crossprod_split3_v1",
                                 crossprod_split3_plain, coeff_rows)


def crossprod_tiled_p(packed, mean, invsd, xp, tm):
    """B1 at ``tm`` SNP rows per block (TILE_TM); bit-identical to
    ``crossprod_p`` on CUDA, :func:`crossprod_plain` on the CPU."""
    if tm not in TILE_TM:
        raise ValueError(f"tm must be one of {TILE_TM}, got {tm}")
    _check_shapes(4 * packed.shape[1], xp, "crossprod_tiled_p")
    if xp.device.type == "cpu":
        return crossprod_plain(packed, mean, invsd, xp)
    return _launch_over_widths("crossprod_tiled", packed,
                               coeff_rows(mean, invsd), xp, packed.shape[0],
                               tm)


def matvec_tiled_p(packed, mean, invsd, v, cr):
    """B2's first design at ``cr`` SNP rows per chunk (TILE_CR): y = W^T
    v, (p, k) -> (n4, k); :func:`matvec_plain` on the CPU.  ``cr`` moves
    the fold points, so it agrees with ``matvec_p`` to rounding only,
    save at production's 64, which gives its bits."""
    if cr not in TILE_CR:
        raise ValueError(f"cr must be one of {TILE_CR}, got {cr}")
    _check_shapes(packed.shape[0], v, "matvec_tiled_p")
    if v.device.type == "cpu":
        return matvec_plain(packed, mean, invsd, v)
    return _launch_over_widths("matvec_tiled", packed,
                               coeff_rows(mean, invsd), v,
                               4 * packed.shape[1], cr)


# name -> (wrapper, plain version) of the four variants, in the sweep's
# order of timing
VARIANTS = {
    "crossprod_stacked": (crossprod_stacked_p, crossprod_stacked_plain),
    "crossprod_intsub": (crossprod_intsub_p, crossprod_intsub_plain),
    "crossprod_nocomp": (crossprod_nocomp_p, crossprod_nocomp_plain),
    "crossprod_split3": (crossprod_split3_p, crossprod_split3_plain),
}
# the four first designs: name (the redesign's and ``_v1``) -> (wrapper,
# plain version, the redesign's)
FIRST_DESIGNS = {
    "crossprod_stacked_v1": (crossprod_stacked_v1_p, crossprod_stacked_plain),
    "crossprod_intsub_v1": (crossprod_intsub_v1_p, crossprod_intsub_plain),
    "crossprod_nocomp_v1": (crossprod_nocomp_v1_p, crossprod_nocomp_plain),
    "crossprod_split3_v1": (crossprod_split3_v1_p, crossprod_split3_plain),
}
