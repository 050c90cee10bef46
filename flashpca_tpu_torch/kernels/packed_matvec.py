"""Fused 2-bit decode -> standardize -> product kernels, with their
plain PyTorch versions.

The genotype matrix W (p SNPs x n4 permuted samples) lives on the card
as raw PLINK packed bytes, SNP-major ``(p, nbytes)`` uint8.  The five
hand-written CUDA kernels (kernels/csrc/) decode tiles of it to
standardized float32 in registers and contract them at once, so the
decoded matrix never reaches device memory:

====  ==================  ============================================
B1    crossprod.cu        z = W x        (n4, k) -> (p, k)
B2    matvec.cu           y = W^T v      (p, k) -> (n4, k)
B3    crossprod_ff.cu     two-float (z_hi, z_err) of W x
B4    matvec_ff.cu        two-float (y_hi, y_err) of W^T (v_hi + v_lo)
B5    matvec_ff.cu        two-float (y_hi, y_err) of W^T v (no v_lo)
====  ==================  ============================================

The wide gram W^T W runs B1 then B2 (B3 then B4 in two-float); the
tall gram W M W^T (M the valid-sample mask) runs B2 then B1, and in
two-float B5, then B3 plus B1 on the eps-sized low half.

Layout: permuted sample space (ops/genotypes.py) -- position
``s*nbytes + b`` holds sample ``4b + s`` -- so an (n4, k) panel is four
contiguous sample planes, one per 2-bit field of a byte.  The kernels
need no padding of either axis: they mask the ragged edges themselves.
A panel of k columns runs at a width KC in {8, 16, 24, 32} (k rounded
up; zero columns are exact no-ops); wider panels run in 32-column
chunks, one launch per chunk.

Dispatch: each wrapper takes its plain version for tensors on the CPU
(the tests' path) and launches its kernel for CUDA float32 tensors.
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.  float64 on CUDA raises NotImplementedError.

``launch_counts`` counts the kernel launches of each wrapper (it is
incremented right where a kernel is launched, and nowhere else), so a
run can show that its products went through the kernels.  Inside
``with time_launches() as log:`` every launch also records a CUDA event
pair, so a run can read each launch's device time afterwards.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.compensated import twosum

KC_WIDTHS = (8, 16, 24, 32)
MAX_KC = KC_WIDTHS[-1]

launch_counts = {"crossprod": 0, "matvec": 0, "crossprod_ff": 0,
                 "matvec_ff": 0, "matvec_ff_novl": 0}
_launch_log: list | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def time_launches():
    """Record (name, kc, start_event, end_event) for every kernel launch
    made inside the block; read ``start.elapsed_time(end)`` (ms) after a
    ``torch.cuda.synchronize()``.  Two events per launch, no sync."""
    global _launch_log
    prev, _launch_log = _launch_log, []
    try:
        yield _launch_log
    finally:
        _launch_log = prev


# ---------------------------------------------------------------------------
# Per-SNP decode constants
# ---------------------------------------------------------------------------

def coeff_rows(mean, invsd):
    """Factored-cubic coefficients (b0, b1, b2), float32 (p,) each.

    (t-1)(b0 + b1 t + b2 t^2) interpolates y(0)=(2-m)i, y(1)=0,
    y(2)=(1-m)i, y(3)=-m*i with b0 = (m-2)i, b1 = (19-12m)i/6,
    b2 = (3m-5)i/6; the root at t=1 (missing) is structural, so missing
    decodes to exactly 0 whatever the rounding."""
    m = mean.to(torch.float32)
    i = invsd.to(torch.float32)
    b0 = (m - 2.0) * i
    b1 = (19.0 - 12.0 * m) * i * (1.0 / 6.0)
    b2 = (3.0 * m - 5.0) * i * (1.0 / 6.0)
    return b0.contiguous(), b1.contiguous(), b2.contiguous()


def lut_rows(lut_hi, lut_lo):
    """(p, 4) hi/lo code tables -> (6, p) float32 rows
    [hi0, hi2, hi3, lo0, lo2, lo3] (code 1 is structurally zero)."""
    return torch.stack([lut[:, c].to(torch.float32)
                        for lut in (lut_hi, lut_lo) for c in (0, 2, 3)]
                       ).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle): the same
# decode and the same chunked TwoSum accumulation as the kernels
# ---------------------------------------------------------------------------

_PLAIN_BUDGET = 64 << 20     # decoded float32 elements per plain chunk / 4


def _decode_plane_cubic(blk, s, b0, b1, b2):
    t = ((blk >> (2 * s)) & 3).to(torch.float32)
    return (t - 1.0) * (b0[:, None] + t * (b1[:, None] + t * b2[:, None]))


def _decode_plane_lut(blk, s, l0, l2, l3):
    t = (blk >> (2 * s)) & 3
    zero = torch.zeros((), dtype=torch.float32, device=blk.device)
    v = torch.where(t == 0, l0[:, None], zero)
    v = torch.where(t == 2, l2[:, None], v)
    return torch.where(t == 3, l3[:, None], v)


def _byte_chunk(p: int) -> int:
    return max(1, _PLAIN_BUDGET // max(1, p))


def _row_chunk(nb: int) -> int:
    return max(1, _PLAIN_BUDGET // max(1, nb))


def crossprod_plain(packed, mean, invsd, xp):
    """z = W xp, (n4, k) -> (p, k): byte chunks decoded with the factored
    cubic, each chunk's float32 partial folded in with TwoSum."""
    p, nb = packed.shape
    k = xp.shape[1]
    b0, b1, b2 = coeff_rows(mean, invsd)
    x = xp.to(torch.float32).reshape(4, nb, k)
    z = torch.zeros((p, k), dtype=torch.float32, device=xp.device)
    err = torch.zeros_like(z)
    cb = _byte_chunk(p)
    for c0 in range(0, nb, cb):
        blk = packed[:, c0: c0 + cb]
        t = torch.zeros_like(z)
        for s in range(4):
            w = _decode_plane_cubic(blk, s, b0, b1, b2)
            t = t + w @ x[s, c0: c0 + cb]
        z, e = twosum(z, t)
        err = err + e
    return z + err


def matvec_plain(packed, mean, invsd, v):
    """y = W^T v, (p, k) -> (n4, k): SNP-row chunks, TwoSum-folded."""
    p, nb = packed.shape
    k = v.shape[1]
    b0, b1, b2 = coeff_rows(mean, invsd)
    v = v.to(torch.float32)
    y = torch.zeros((4, nb, k), dtype=torch.float32, device=v.device)
    err = torch.zeros_like(y)
    rc = _row_chunk(nb)
    for r0 in range(0, p, rc):
        blk = packed[r0: r0 + rc]
        co = (b0[r0: r0 + rc], b1[r0: r0 + rc], b2[r0: r0 + rc])
        t = torch.stack([_decode_plane_cubic(blk, s, *co).T @ v[r0: r0 + rc]
                         for s in range(4)])
        y, e = twosum(y, t)
        err = err + e
    return (y + err).reshape(4 * nb, k)


def crossprod_ff_plain(packed, lut6, xp):
    """(z_hi, z_err) of W xp with W = W_hi + W_lo (exact LUT selects):
    x W_hi TwoSum-folded per byte chunk, x W_lo added into err."""
    p, nb = packed.shape
    k = xp.shape[1]
    h0, h2, h3, g0, g2, g3 = lut6
    x = xp.to(torch.float32).reshape(4, nb, k)
    z = torch.zeros((p, k), dtype=torch.float32, device=xp.device)
    err = torch.zeros_like(z)
    cb = _byte_chunk(p)
    for c0 in range(0, nb, cb):
        blk = packed[:, c0: c0 + cb]
        t = torch.zeros_like(z)
        c = torch.zeros_like(z)
        for s in range(4):
            xs = x[s, c0: c0 + cb]
            t = t + _decode_plane_lut(blk, s, h0, h2, h3) @ xs
            c = c + _decode_plane_lut(blk, s, g0, g2, g3) @ xs
        z, e = twosum(z, t)
        err = err + e + c
    return z, err


def matvec_ff_plain(packed, lut6, vh, vl):
    """(y_hi, y_err) of W^T (vh + vl): vh W_hi TwoSum-folded per SNP-row
    chunk, vh W_lo + vl W_hi added into err (``vl=None``: no vl W_hi)."""
    p, nb = packed.shape
    k = vh.shape[1]
    vh = vh.to(torch.float32)
    y = torch.zeros((4, nb, k), dtype=torch.float32, device=vh.device)
    err = torch.zeros_like(y)
    rc = _row_chunk(nb)
    for r0 in range(0, p, rc):
        blk = packed[r0: r0 + rc]
        lh = [lut6[i, r0: r0 + rc] for i in (0, 1, 2)]
        ll = [lut6[i, r0: r0 + rc] for i in (3, 4, 5)]
        a = vh[r0: r0 + rc]
        ts, cs = [], []
        for s in range(4):
            wh = _decode_plane_lut(blk, s, *lh).T
            wl = _decode_plane_lut(blk, s, *ll).T
            ts.append(wh @ a)
            c = wl @ a
            if vl is not None:
                c = c + wh @ vl[r0: r0 + rc].to(torch.float32)
            cs.append(c)
        y, e = twosum(y, torch.stack(ts))
        err = err + e + torch.stack(cs)
    return y.reshape(4 * nb, k), err.reshape(4 * nb, k)


def matvec_ff_novl_plain(packed, lut6, vh):
    """(y_hi, y_err) of W^T vh: the fold of :func:`matvec_ff_plain`
    without the vl W_hi term."""
    return matvec_ff_plain(packed, lut6, vh, None)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check_cuda(packed, *tensors):
    """Validate the kernels' operands: one CUDA device, uint8 packed
    bytes, float32 operands (the panels are made contiguous by
    ``_padded``; the per-SNP rows must be)."""
    dev = packed.device
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise ValueError(f"packed must be 2-D uint8, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    for t in (packed, *tensors):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, packed on {dev}")
        if t.dtype == torch.float64:
            raise NotImplementedError(
                "the CUDA kernels are float32; float64 on CUDA is not "
                "ported yet (run float64 on the CPU)")
        if t is not packed and t.dtype != torch.float32:
            raise ValueError(f"expected float32 operands, got {t.dtype}")
        if t.ndim == 1 and not t.is_contiguous():
            raise ValueError("per-SNP rows must be contiguous")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")


def _check_lut6(packed, lut6):
    if tuple(lut6.shape) != (6, packed.shape[0]) or not lut6.is_contiguous():
        raise ValueError(f"lut6 must be a contiguous (6, {packed.shape[0]}) "
                         f"table, got {tuple(lut6.shape)}")


def _run(name, *args):
    """Launch kernel ``name`` on the current stream of the operands'
    device; raise on a nonzero cudaGetLastError()."""
    from ._build import kernel

    fn = kernel(name)
    dev = args[0].device
    stream = torch.cuda.current_stream(dev)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if _launch_log is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    with torch.cuda.device(dev):
        rc = fn(*ptrs, stream.cuda_stream)
    launch_counts[name] += 1
    if _launch_log is not None:
        ev[1].record(stream)
        _launch_log.append((name, args[-1], *ev))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc} "
                           f"({torch.cuda.get_device_name(args[0].device)})")


def _widths(k: int):
    """Column chunks (c0, c1, KC) covering a k-column panel."""
    out = []
    for c0 in range(0, k, MAX_KC):
        kc = min(MAX_KC, k - c0)
        out.append((c0, c0 + kc, next(w for w in KC_WIDTHS if w >= kc)))
    return out


def _padded(x, c0, c1, kc):
    """Columns [c0, c1) of x as a contiguous float32 (rows, kc) panel,
    zero-filled beyond c1 - c0."""
    if c0 == 0 and c1 - c0 == kc == x.shape[1] and x.is_contiguous():
        return x
    out = torch.zeros((x.shape[0], kc), dtype=torch.float32, device=x.device)
    out[:, : c1 - c0] = x[:, c0:c1]
    return out


def _launch_crossprod(packed, coeffs, x, kc):
    p, nb = packed.shape
    z = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
    _run("crossprod", packed, *coeffs, x, z, p, nb, kc)
    return z


def _launch_matvec(packed, coeffs, v, kc):
    p, nb = packed.shape
    y = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    _run("matvec", packed, *coeffs, v, y, p, nb, kc)
    return y


def _launch_crossprod_ff(packed, lut6, x, kc):
    p, nb = packed.shape
    zh = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
    zl = torch.empty_like(zh)
    _run("crossprod_ff", packed, lut6, x, zh, zl, p, nb, kc)
    return zh, zl


def _launch_matvec_ff(packed, lut6, vh, vl, kc):
    p, nb = packed.shape
    yh = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    yl = torch.empty_like(yh)
    _run("matvec_ff", packed, lut6, vh, vl, yh, yl, p, nb, kc)
    return yh, yl


def _launch_matvec_ff_novl(packed, lut6, vh, kc):
    p, nb = packed.shape
    yh = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    yl = torch.empty_like(yh)
    _run("matvec_ff_novl", packed, lut6, vh, yh, yl, p, nb, kc)
    return yh, yl


def _check_shapes(rows, x, what):
    if x.ndim != 2 or x.shape[0] != rows:
        raise ValueError(f"{what}: expected ({rows}, k), got "
                         f"{tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Public wrappers (permuted space)
# ---------------------------------------------------------------------------

def crossprod_p(packed, mean, invsd, xp):
    """z = W xp: (n4, k) -> (p, k).  B1 on CUDA, plain on the CPU."""
    _check_shapes(4 * packed.shape[1], xp, "crossprod_p")
    if xp.device.type == "cpu":
        return crossprod_plain(packed, mean, invsd, xp)
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, xp, *coeffs)
    outs = [_launch_crossprod(packed, coeffs, _padded(xp, c0, c1, kc), kc)
            [:, : c1 - c0] for c0, c1, kc in _widths(xp.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def matvec_p(packed, mean, invsd, v):
    """y = W^T v: (p, k) -> (n4, k).  B2 on CUDA, plain on the CPU."""
    _check_shapes(packed.shape[0], v, "matvec_p")
    if v.device.type == "cpu":
        return matvec_plain(packed, mean, invsd, v)
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, v, *coeffs)
    outs = [_launch_matvec(packed, coeffs, _padded(v, c0, c1, kc), kc)
            [:, : c1 - c0] for c0, c1, kc in _widths(v.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gram_matvec_p(packed, mean, invsd, xp):
    """yp = W^T (W xp): (n4, k) -> (n4, k) -- B1 then B2 (two launches
    per column chunk; the SNP-space intermediate stays zero-padded)."""
    _check_shapes(4 * packed.shape[1], xp, "gram_matvec_p")
    if xp.device.type == "cpu":
        return matvec_plain(packed, mean, invsd,
                            crossprod_plain(packed, mean, invsd, xp))
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, xp, *coeffs)
    outs = []
    for c0, c1, kc in _widths(xp.shape[1]):
        z = _launch_crossprod(packed, coeffs, _padded(xp, c0, c1, kc), kc)
        outs.append(_launch_matvec(packed, coeffs, z, kc)[:, : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def crossprod_ff_p(packed, lut6, xp):
    """(z_hi, z_err) of W xp: (n4, k) -> 2 x (p, k).  B3 on CUDA."""
    _check_shapes(4 * packed.shape[1], xp, "crossprod_ff_p")
    if xp.device.type == "cpu":
        return crossprod_ff_plain(packed, lut6, xp)
    _check_cuda(packed, xp, lut6)
    _check_lut6(packed, lut6)
    outs = [_launch_crossprod_ff(packed, lut6, _padded(xp, c0, c1, kc), kc)
            for c0, c1, kc in _widths(xp.shape[1])]
    return _cat_pairs(outs, _widths(xp.shape[1]))


def matvec_ff_p(packed, lut6, vh, vl):
    """(y_hi, y_err) of W^T (vh + vl): 2 x (p, k) -> 2 x (n4, k).  B4 on
    CUDA."""
    _check_shapes(packed.shape[0], vh, "matvec_ff_p")
    _check_shapes(packed.shape[0], vl, "matvec_ff_p")
    if vh.device.type == "cpu":
        return matvec_ff_plain(packed, lut6, vh, vl)
    _check_cuda(packed, vh, vl, lut6)
    _check_lut6(packed, lut6)
    w = _widths(vh.shape[1])
    outs = [_launch_matvec_ff(packed, lut6, _padded(vh, c0, c1, kc),
                              _padded(vl, c0, c1, kc), kc)
            for c0, c1, kc in w]
    return _cat_pairs(outs, w)


def matvec_ff_novl_p(packed, lut6, vh):
    """(y_hi, y_err) of W^T vh: (p, k) -> 2 x (n4, k).  B5 on CUDA."""
    _check_shapes(packed.shape[0], vh, "matvec_ff_novl_p")
    if vh.device.type == "cpu":
        return matvec_ff_novl_plain(packed, lut6, vh)
    _check_cuda(packed, vh, lut6)
    _check_lut6(packed, lut6)
    w = _widths(vh.shape[1])
    outs = [_launch_matvec_ff_novl(packed, lut6, _padded(vh, c0, c1, kc), kc)
            for c0, c1, kc in w]
    return _cat_pairs(outs, w)


def _cat_pairs(outs, widths):
    hs = [o[0][:, : c1 - c0] for o, (c0, c1, _) in zip(outs, widths)]
    ls = [o[1][:, : c1 - c0] for o, (c0, c1, _) in zip(outs, widths)]
    if len(hs) == 1:
        return hs[0], ls[0]
    return torch.cat(hs, dim=1), torch.cat(ls, dim=1)


def gram_ff_p(packed, lut_hi, lut_lo, xp):
    """(y_hi, y_lo) of the sample-space gram W^T (W xp) in two-float
    arithmetic -- B3 then B4.  The caller masks byte-padding positions
    on input and output."""
    _check_shapes(4 * packed.shape[1], xp, "gram_ff_p")
    lut6 = lut_rows(lut_hi, lut_lo)
    if xp.device.type == "cpu":
        zh, zl = crossprod_ff_plain(packed, lut6, xp)
        return matvec_ff_plain(packed, lut6, zh, zl)
    _check_cuda(packed, xp, lut6)
    _check_lut6(packed, lut6)
    w = _widths(xp.shape[1])
    outs = []
    for c0, c1, kc in w:
        zh, zl = _launch_crossprod_ff(packed, lut6, _padded(xp, c0, c1, kc),
                                      kc)
        outs.append(_launch_matvec_ff(packed, lut6, zh, zl, kc))
    return _cat_pairs(outs, w)


def gram_tall_ff_plain(packed, lut_hi, lut_lo, mean, invsd, v, valid):
    """Plain version of :func:`gram_tall_ff_p` (any device): the plain
    versions of B5, B3 and B1 with the mask between the stages."""
    lut6 = lut_rows(lut_hi, lut_lo)
    m = valid.to(torch.float32)[:, None]
    yh, yl = matvec_ff_novl_plain(packed, lut6, v)
    zh, zl = crossprod_ff_plain(packed, lut6, yh * m)
    return zh, zl + crossprod_plain(packed, mean, invsd, yl * m)


def gram_tall_ff_p(packed, lut_hi, lut_lo, mean, invsd, v, valid):
    """(z_hi, z_lo) of the SNP-space gram W M W^T v in two-float
    arithmetic, M = diag(valid) the valid-sample mask (n4,): B5, the
    mask on both halves, B3 on y_hi, and B1 on y_lo added into z_lo.

    The eps-sized correction W y_lo rides the plain kernel B1 with its
    factored-cubic decode, as in the JAX package: that decode differs
    from the exact hi table by ~eps, which lands at eps^2 of the
    result."""
    _check_shapes(packed.shape[0], v, "gram_tall_ff_p")
    if tuple(valid.shape) != (4 * packed.shape[1],):
        raise ValueError(
            f"gram_tall_ff_p: valid must be ({4 * packed.shape[1]},), got "
            f"{tuple(valid.shape)}")
    if v.device.type == "cpu":
        return gram_tall_ff_plain(packed, lut_hi, lut_lo, mean, invsd, v,
                                  valid)
    lut6 = lut_rows(lut_hi, lut_lo)
    m = valid.to(torch.float32)[:, None]
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, v, lut6, m, *coeffs)
    _check_lut6(packed, lut6)
    w = _widths(v.shape[1])
    outs = []
    for c0, c1, kc in w:
        yh, yl = _launch_matvec_ff_novl(packed, lut6, _padded(v, c0, c1, kc),
                                        kc)
        zh, zl = _launch_crossprod_ff(packed, lut6, yh.mul_(m), kc)
        zl += _launch_crossprod(packed, coeffs, yl.mul_(m), kc)
        outs.append((zh, zl))
    return _cat_pairs(outs, w)
