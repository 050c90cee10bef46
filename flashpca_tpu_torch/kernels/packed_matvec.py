"""Fused 2-bit decode -> standardize -> product kernels, with their
plain PyTorch versions.

The genotype matrix W (p SNPs x n4 permuted samples) lives on the card
as raw PLINK packed bytes, SNP-major ``(p, nbytes)`` uint8.  The
hand-written CUDA kernels (kernels/csrc/) decode tiles of it to
standardized float32 in registers and contract them at once, so the
decoded matrix never reaches device memory:

====  ===================  ===========================================
B1    crossprod_v2.cu      z = W x        (n4, k) -> (p, k)
B2    matvec_v2.cu         y = W^T v      (p, k) -> (n4, k)
B3    crossprod_ff_v2.cu   two-float (z_hi, z_err) of W x
B4    matvec_ff_v2.cu      two-float (y_hi, y_err) of W^T (v_hi + v_lo)
B5    matvec_ff_novl.cu    two-float (y_hi, y_err) of W^T v (no v_lo)
B1    crossprod_narrow.cu  B1 at one column: z = W x, (n4,) -> (p,)
B2    matvec_narrow.cu     B2 at one column: y = W^T v, (p,) -> (n4,)
====  ===================  ===========================================

B1, B2, B3 and B4 each have one comparison entry that no operator
launches: their first designs, in crossprod.cu (``crossprod_v1_p``),
matvec.cu (``matvec_v1_p``), crossprod_ff.cu (``crossprod_ff_v1_p``)
and matvec_ff.cu (``matvec_ff_v1_p``, the ``HAS_VL=true``
instantiation), whose sums are bit for bit B1's, B2's, B3's and B4's.
B5 has three: its first
design, the ``HAS_VL=false`` instantiation of matvec_ff.cu
(``matvec_ff_novl_v1_p``), and its design at two other tiles in
matvec_ff_novl_variants.cu (``matvec_ff_novl_c4_p``,
``matvec_ff_novl_cr128_p``); chip_smoke.py times them beside it.

The wide gram W^T W runs B1 then B2 (B3 then B4 in two-float); the
tall gram W M W^T (M the valid-sample mask) runs B2 then B1, and in
two-float B5, then B3 plus B1 on the eps-sized low half.

Layout: permuted sample space (ops/genotypes.py) -- position
``s*nbytes + b`` holds sample ``4b + s`` -- so an (n4, k) panel is four
contiguous sample planes, one per 2-bit field of a byte.  The kernels
need no padding of either axis: they mask the ragged edges themselves.
A panel of k columns runs at a width KC in {8, 16, 24, 32} (k rounded
up; zero columns are exact no-ops); wider panels run in 32-column
chunks, one launch per chunk.  B1 and B2 take a one-column chunk (a
vector, or the last column of a 33-column panel) to their one-column
kernels on the column as it is, with no padded copy (:func:`_launches`
decides, :func:`_crossprod_chunk` and :func:`_matvec_chunk` launch, for
``crossprod_p``, ``matvec_p`` and ``gram_matvec_p``): their sums are
column 0 of B1's and B2's at kc 8 bit for bit, so a one-column product
gives the same bits either way.  The tall two-float gram keeps kc 8 for
one column (:func:`gram_tall_ff_p`).

Dispatch: each wrapper takes its plain version for tensors on the CPU
(the tests' path) and launches its kernel for CUDA float32 tensors.
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.  A float64 CUDA tensor raises NotImplementedError
(float64 operators run the functional core, never these wrappers).

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

# the kernels the operators launch (B1-B5, B1 and B2 at one column),
# and the kernel sweep's
# entries (kernels/crossprod_variants.py), which no operator launches
OPERATOR_KERNELS = ("crossprod", "matvec", "crossprod_ff", "matvec_ff",
                    "matvec_ff_novl", "crossprod_narrow", "matvec_narrow")
SWEEP_KERNELS = ("crossprod_tiled", "matvec_tiled", "crossprod_stacked",
                 "crossprod_intsub", "crossprod_split3", "crossprod_nocomp")
# V1's, V2's, V4's and V3's first designs, which the sweep times beside
# their redesigns (kernels/crossprod_variants.py)
VARIANT_FIRST_KERNELS = ("crossprod_stacked_v1", "crossprod_intsub_v1",
                         "crossprod_nocomp_v1", "crossprod_split3_v1")
# B1's, B2's, B3's, B4's and B5's comparison entries, which no operator
# launches either
B1_KERNELS = ("crossprod_v1",)
B2_KERNELS = ("matvec_v1",)
B3_KERNELS = ("crossprod_ff_v1",)
B4_KERNELS = ("matvec_ff_v1",)
NOVL_KERNELS = ("matvec_ff_novl_v1", "matvec_ff_novl_c4",
                "matvec_ff_novl_cr128")
launch_counts = dict.fromkeys(
    OPERATOR_KERNELS + SWEEP_KERNELS + VARIANT_FIRST_KERNELS + B1_KERNELS
    + B2_KERNELS + B3_KERNELS + B4_KERNELS + NOVL_KERNELS, 0)
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
                "the CUDA kernels are float32; a float64 operator runs "
                "the functional core (ops/operator.py), not the kernels")
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


def _launches(k, narrow=True):
    """(c0, c1, KC) of each B1 or B2 launch over a k-column panel: the
    chunks of :func:`_widths`, and with ``narrow`` a one-column chunk at
    KC 1, the one-column kernels' (B1's and B2's first designs, which
    have none, pass ``narrow=False``)."""
    return [(c0, c1, 1 if narrow and c1 - c0 == 1 else kc)
            for c0, c1, kc in _widths(k)]


def _padded(x, c0, c1, kc):
    """Columns [c0, c1) of x as a contiguous float32 (rows, kc) panel,
    zero-filled beyond c1 - c0."""
    if c0 == 0 and c1 - c0 == kc == x.shape[1] and x.is_contiguous():
        return x
    out = torch.zeros((x.shape[0], kc), dtype=torch.float32, device=x.device)
    out[:, : c1 - c0] = x[:, c0:c1]
    return out


def _launch_crossprod(packed, coeffs, x, kc, name="crossprod"):
    """Launch B1 (or, by ``name``, its first design)."""
    p, nb = packed.shape
    z = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
    _run(name, packed, *coeffs, x, z, p, nb, kc)
    return z


def _launch_matvec(packed, coeffs, v, kc, name="matvec"):
    """Launch B2 (or, by ``name``, its first design)."""
    p, nb = packed.shape
    y = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    _run(name, packed, *coeffs, v, y, p, nb, kc)
    return y


def _launch_crossprod_narrow(packed, coeffs, x):
    """Launch B1's one-column kernel on the contiguous (n4,) column
    ``x``; returns z (p, 1)."""
    p, nb = packed.shape
    z = torch.empty((p, 1), dtype=torch.float32, device=packed.device)
    _run("crossprod_narrow", packed, *coeffs, x, z, p, nb, 1)
    return z


def _launch_matvec_narrow(packed, coeffs, v):
    """Launch B2's one-column kernel on the contiguous (p,) column ``v``;
    returns y (n4, 1)."""
    p, nb = packed.shape
    y = torch.empty((4 * nb, 1), dtype=torch.float32, device=packed.device)
    _run("matvec_narrow", packed, *coeffs, v, y, p, nb, 1)
    return y


def _crossprod_chunk(name, packed, coeffs, xp, c0, c1, kc):
    """z (p, kc) of columns [c0, c1) of xp, its columns past c1 - c0
    zero: B1 (or, by ``name``, its first design) at ``kc``, or at KC 1
    its one-column kernel."""
    if kc == 1:
        return _launch_crossprod_narrow(packed, coeffs,
                                        xp[:, c0].contiguous())
    return _launch_crossprod(packed, coeffs, _padded(xp, c0, c1, kc), kc,
                             name)


def _matvec_chunk(name, packed, coeffs, v, c0, c1, kc):
    """y (n4, kc) of columns [c0, c1) of v, its columns past c1 - c0
    zero: B2 (or, by ``name``, its first design) at ``kc``, or at KC 1
    its one-column kernel."""
    if kc == 1:
        return _launch_matvec_narrow(packed, coeffs, v[:, c0].contiguous())
    return _launch_matvec(packed, coeffs, _padded(v, c0, c1, kc), kc, name)


def _launch_crossprod_ff(packed, lut6, x, kc, name="crossprod_ff"):
    """Launch B3 (or, by ``name``, its first design)."""
    p, nb = packed.shape
    zh = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
    zl = torch.empty_like(zh)
    _run(name, packed, lut6, x, zh, zl, p, nb, kc)
    return zh, zl


def _launch_matvec_ff(packed, lut6, vh, vl, kc, name="matvec_ff"):
    """Launch B4 (or, by ``name``, its first design)."""
    p, nb = packed.shape
    yh = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    yl = torch.empty_like(yh)
    _run(name, packed, lut6, vh, vl, yh, yl, p, nb, kc)
    return yh, yl


def _launch_matvec_ff_novl(packed, lut6, vh, kc):
    return _launch_novl("matvec_ff_novl", packed, lut6, vh, kc)


def _launch_novl(name, packed, lut6, vh, kc):
    """Launch B5 or one of its comparison entries."""
    p, nb = packed.shape
    yh = torch.empty((4 * nb, kc), dtype=torch.float32, device=packed.device)
    yl = torch.empty_like(yh)
    _run(name, packed, lut6, vh, yh, yl, p, nb, kc)
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
    return _crossprod_p("crossprod", packed, mean, invsd, xp)


def crossprod_v1_p(packed, mean, invsd, xp):
    """B1's first design (crossprod.cu); the sums of :func:`crossprod_p`
    bit for bit, :func:`crossprod_plain` on the CPU."""
    return _crossprod_p("crossprod_v1", packed, mean, invsd, xp)


def _crossprod_p(name, packed, mean, invsd, xp):
    _check_shapes(4 * packed.shape[1], xp, f"{name}_p")
    if xp.device.type == "cpu":
        return crossprod_plain(packed, mean, invsd, xp)
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, xp, *coeffs)
    outs = [_crossprod_chunk(name, packed, coeffs, xp, c0, c1, kc)
            [:, : c1 - c0]
            for c0, c1, kc in _launches(xp.shape[1], name == "crossprod")]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def matvec_p(packed, mean, invsd, v):
    """y = W^T v: (p, k) -> (n4, k).  B2 on CUDA, plain on the CPU."""
    return _matvec_p("matvec", packed, mean, invsd, v)


def matvec_v1_p(packed, mean, invsd, v):
    """B2's first design (matvec.cu); the sums of :func:`matvec_p` bit for
    bit, :func:`matvec_plain` on the CPU."""
    return _matvec_p("matvec_v1", packed, mean, invsd, v)


def _matvec_p(name, packed, mean, invsd, v):
    _check_shapes(packed.shape[0], v, f"{name}_p")
    if v.device.type == "cpu":
        return matvec_plain(packed, mean, invsd, v)
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, v, *coeffs)
    outs = [_matvec_chunk(name, packed, coeffs, v, c0, c1, kc)[:, : c1 - c0]
            for c0, c1, kc in _launches(v.shape[1], name == "matvec")]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gram_matvec_p(packed, mean, invsd, xp):
    """yp = W^T (W xp): (n4, k) -> (n4, k) -- B1 then B2 (two launches
    per column chunk)."""
    _check_shapes(4 * packed.shape[1], xp, "gram_matvec_p")
    if xp.device.type == "cpu":
        return matvec_plain(packed, mean, invsd,
                            crossprod_plain(packed, mean, invsd, xp))
    coeffs = coeff_rows(mean, invsd)
    _check_cuda(packed, xp, *coeffs)
    outs = []
    for c0, c1, kc in _launches(xp.shape[1]):
        # the SNP-space intermediate stays (p, kc), zero past c1 - c0:
        # B2 reads it as it is
        z = _crossprod_chunk("crossprod", packed, coeffs, xp, c0, c1, kc)
        outs.append(_matvec_chunk("matvec", packed, coeffs, z, 0, kc, kc)
                    [:, : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def crossprod_ff_p(packed, lut6, xp):
    """(z_hi, z_err) of W xp: (n4, k) -> 2 x (p, k).  B3 on CUDA."""
    return _crossprod_ff_p("crossprod_ff", packed, lut6, xp)


def crossprod_ff_v1_p(packed, lut6, xp):
    """B3's first design (crossprod_ff.cu); the sums of
    :func:`crossprod_ff_p` bit for bit, :func:`crossprod_ff_plain` on the
    CPU."""
    return _crossprod_ff_p("crossprod_ff_v1", packed, lut6, xp)


def _crossprod_ff_p(name, packed, lut6, xp):
    _check_shapes(4 * packed.shape[1], xp, f"{name}_p")
    if xp.device.type == "cpu":
        return crossprod_ff_plain(packed, lut6, xp)
    _check_cuda(packed, xp, lut6)
    _check_lut6(packed, lut6)
    w = _widths(xp.shape[1])
    outs = [_launch_crossprod_ff(packed, lut6, _padded(xp, c0, c1, kc), kc,
                                 name)
            for c0, c1, kc in w]
    return _cat_pairs(outs, w)


def matvec_ff_p(packed, lut6, vh, vl):
    """(y_hi, y_err) of W^T (vh + vl): 2 x (p, k) -> 2 x (n4, k).  B4 on
    CUDA."""
    return _matvec_ff_p("matvec_ff", packed, lut6, vh, vl)


def matvec_ff_v1_p(packed, lut6, vh, vl):
    """B4's first design (matvec_ff.cu, ``HAS_VL=true``); the sums of
    :func:`matvec_ff_p` bit for bit, :func:`matvec_ff_plain` on the
    CPU."""
    return _matvec_ff_p("matvec_ff_v1", packed, lut6, vh, vl)


def _matvec_ff_p(name, packed, lut6, vh, vl):
    _check_shapes(packed.shape[0], vh, f"{name}_p")
    _check_shapes(packed.shape[0], vl, f"{name}_p")
    if vh.device.type == "cpu":
        return matvec_ff_plain(packed, lut6, vh, vl)
    _check_cuda(packed, vh, vl, lut6)
    _check_lut6(packed, lut6)
    w = _widths(vh.shape[1])
    outs = [_launch_matvec_ff(packed, lut6, _padded(vh, c0, c1, kc),
                              _padded(vl, c0, c1, kc), kc, name)
            for c0, c1, kc in w]
    return _cat_pairs(outs, w)


def matvec_ff_novl_p(packed, lut6, vh):
    """(y_hi, y_err) of W^T vh: (p, k) -> 2 x (n4, k).  B5 on CUDA."""
    return _novl_p("matvec_ff_novl", packed, lut6, vh)


def matvec_ff_novl_v1_p(packed, lut6, vh):
    """B5's first design (matvec_ff.cu, ``HAS_VL=false``); the function
    of :func:`matvec_ff_novl_p`, :func:`matvec_ff_novl_plain` on the
    CPU."""
    return _novl_p("matvec_ff_novl_v1", packed, lut6, vh)


def matvec_ff_novl_c4_p(packed, lut6, vh):
    """B5 at 4 columns per thread (production: 8); the function of
    :func:`matvec_ff_novl_p`, :func:`matvec_ff_novl_plain` on the CPU."""
    return _novl_p("matvec_ff_novl_c4", packed, lut6, vh)


def matvec_ff_novl_cr128_p(packed, lut6, vh):
    """B5 folding every 128 SNP rows (production: 64); the function of
    :func:`matvec_ff_novl_p` up to the fold's rounding,
    :func:`matvec_ff_novl_plain` on the CPU."""
    return _novl_p("matvec_ff_novl_cr128", packed, lut6, vh)


def _novl_p(name, packed, lut6, vh):
    _check_shapes(packed.shape[0], vh, f"{name}_p")
    if vh.device.type == "cpu":
        return matvec_ff_novl_plain(packed, lut6, vh)
    _check_cuda(packed, vh, lut6)
    _check_lut6(packed, lut6)
    w = _widths(vh.shape[1])
    outs = [_launch_novl(name, packed, lut6, _padded(vh, c0, c1, kc), kc)
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
    result.  A one-column chunk stays at kc 8 here, B1 included: B5 and
    B3 have no one-column design, and B1 adds into the kc-8 z_lo on the
    kc-8 y_lo that B5 wrote."""
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
