"""Matrix-free genotype operators, on one device or sharded over a mesh.

``PackedOperator`` is the counterpart of the reference's ``SVDWide``
(svdwide.h:11-107): products against the implicitly standardized
genotype matrix X (N samples x p SNPs), where X never materializes --
the packed 2-bit bytes decode to standardized floats on the fly.
``TallPackedOperator`` holds the same bytes for the tall path, whose
eigenproblem is the p x p gram X^T X (for N >> p).
``StreamingPackedOperator`` computes the wide products with the bytes
left on the host, staged to the card in blocks of SNP rows (bounded
device memory, the reference's ``SVDWideOnline``), and
``TallStreamingOperator`` the tall ones, staged in blocks of samples.
``DenseOperator`` holds a standardized numeric matrix whole and computes
the same products with ``torch.matmul`` (no kernel of its own).

Wide products (reference naming in parens):

* ``perform_op(x)``  : y = X X^T x        (perform_op / perform_op_mat)
* ``crossprod(x)``   : z = X^T x          (crossprod / crossprod2)
* ``prod(v)``        : y = X v            (prod / prod3)
* ``perform_op_ff``  : the same gram as a two-float (hi, lo) pair
* ``snp_sumsq`` / ``trace`` : per-SNP sums of squares and their total

Two paths compute the same products:

* on CUDA at float32 the hand-written kernels B1-B5
  (kernels/packed_matvec.py);
* the blocked PyTorch functional core below (decode a block of SNP
  rows, then matmul): on the CPU in float32 or float64 (or, with
  ``use_kernels=True``, the kernels' plain versions instead), and on
  CUDA at float64 (:func:`runs_kernels` states the rule).

No padding of either axis is needed: the kernels mask their own ragged
edges and the core slices its last block.  Byte-padding SAMPLE
positions (the garbage codes past n in the last byte) are masked on
input and output of every gram product, which keeps it symmetric.

With a ``mesh`` (parallel/dist.py) every packed operator splits its
bytes into shards: SNP rows on the wide gram, byte columns (samples) on
the tall one, and each staged block of a streaming operator likewise.
Each shard runs the same kernels on its own device; the partial
products are summed in shard order on the process's first device, then
across processes, and sharded outputs (``crossprod``'s SNP rows, the
tall ``prod``'s samples) are gathered.  Two-float pairs fold with
TwoSum, shard by shard and process by process.  The resident wide
operator keeps each shard's decode constants on its device and runs a
product in three phases -- the panel to every shard, every shard's
kernels, the partials home -- so that its cards work at the same time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..io.plink import PACK_DENSITY, bytes_per_snp
from ..utils.device import as_torch_dtype, default_dtype, resolve_device
from ..utils.trace import span, width
from .genotypes import (
    decode_standardized,
    permute_samples,
    permute_samples_np,
    unpermute_samples,
    valid_mask_permuted,
)
from .standardize import lookup_tables


def _acc(acc, t):
    """``acc + t``, or ``t`` itself when nothing is accumulated yet."""
    return t if acc is None else acc + t


def _fold(pair, t):
    """Two-float pair ``t`` folded into ``pair`` by TwoSum: the hi
    halves' rounding error and both lo halves go to lo."""
    if pair is None:
        return t
    from .compensated import twosum

    hi, e = twosum(pair[0], t[0])
    return hi, pair[1] + e + t[1]


def _moved(t, dev):
    """A tensor, or a pair of them, on ``dev``."""
    if isinstance(t, tuple):
        return tuple(x.to(dev) for x in t)
    return t.to(dev)


def window_valid(n_samples: int, lo: int, width: int, dtype,
                 device=None) -> torch.Tensor:
    """(4 width,) valid-sample mask of the byte columns [lo, lo + width)
    in their permuted layout: position s * width + b holds sample
    4 (lo + b) + s, zero past ``n_samples``."""
    b = torch.arange(lo, lo + width, dtype=torch.int64)
    samples = PACK_DENSITY * b[None, :] + torch.arange(PACK_DENSITY)[:, None]
    return (samples < n_samples).reshape(-1).to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Functional core: blocked products in permuted sample space
# ---------------------------------------------------------------------------

def budget_block_size(rows: int, n4: int, itemsize: int = 4,
                      cap: int | None = None) -> int:
    """Largest divisor of ``rows`` whose DECODED (bs, n4) block stays
    within a ~128 MiB budget (optionally capped)."""
    budget = max(1, (128 << 20) // max(1, n4 * itemsize))
    bs = max(1, min(rows, budget, cap if cap else rows))
    while rows % bs:
        bs -= 1
    return bs


def _blocks(p: int, block_size: int):
    return range(0, p, block_size)


def gram_matvec_p(packed, mean, invsd, xp, *, block_size):
    """yp = W^T (W xp): (n4, k) -> (n4, k), permuted space; W is the
    (p, n4) standardized matrix, decoded blockwise."""
    y = torch.zeros_like(xp)
    for s in _blocks(packed.shape[0], block_size):
        sl = slice(s, s + block_size)
        W = decode_standardized(packed[sl], mean[sl], invsd[sl], xp.dtype)
        y = y + W.T @ (W @ xp)
    return y


def crossprod_p(packed, mean, invsd, xp, *, block_size):
    """z = W xp: (n4, k) -> (p, k)."""
    outs = []
    for s in _blocks(packed.shape[0], block_size):
        sl = slice(s, s + block_size)
        W = decode_standardized(packed[sl], mean[sl], invsd[sl], xp.dtype)
        outs.append(W @ xp)
    return torch.cat(outs, dim=0)


def matvec_p(packed, mean, invsd, v, *, block_size):
    """yp = W^T v: (p, k) -> (n4, k) (y = X v in sample space)."""
    n4 = packed.shape[1] * PACK_DENSITY
    y = torch.zeros((n4, v.shape[1]), dtype=v.dtype, device=v.device)
    for s in _blocks(packed.shape[0], block_size):
        sl = slice(s, s + block_size)
        W = decode_standardized(packed[sl], mean[sl], invsd[sl], v.dtype)
        y = y + W.T @ v[sl]
    return y


def snp_sumsq_p(packed, mean, invsd, valid, *, block_size):
    """Per-SNP sum of squared standardized genotypes, (p,); ``valid``
    masks out byte-padding sample positions."""
    outs = []
    for s in _blocks(packed.shape[0], block_size):
        sl = slice(s, s + block_size)
        W = decode_standardized(packed[sl], mean[sl], invsd[sl], valid.dtype)
        outs.append((W * W) @ valid)
    return torch.cat(outs, dim=0)


def _host_sumsq(snp_sumsq, n_snps: int) -> np.ndarray | None:
    """Validate a precomputed per-SNP sum of squared standardized
    genotypes (float64 host vector).  Passing one makes ``trace`` /
    ``snp_sumsq`` free: no decode pass at all."""
    if snp_sumsq is None:
        return None
    arr = np.asarray(snp_sumsq, dtype=np.float64)
    if arr.shape != (n_snps,):
        raise ValueError(
            f"snp_sumsq must have shape ({n_snps},), got {arr.shape}")
    return arr


# ---------------------------------------------------------------------------
# The operators
# ---------------------------------------------------------------------------

def runs_kernels(device_type: str, dtype, use_kernels=None) -> bool:
    """Whether an operator runs its products through the kernel wrappers
    (kernels/packed_matvec.py) or the functional core above.

    On CUDA the dtype alone decides: float32 runs the kernels (a float32
    operator that cannot run them fails; ``use_kernels=False`` raises)
    and float64 runs the functional core on the card, as the JAX
    package's float64 runs its jnp path.  On the CPU ``use_kernels=True``
    selects the kernels' plain versions (float32) and anything else the
    functional core.  The kernels are float32, so ``use_kernels=True``
    with float64 raises on either device."""
    if use_kernels and dtype != torch.float32:
        raise ValueError("use_kernels=True runs the float32 kernels (their "
                         "plain versions on the CPU); pass dtype=float32, "
                         "or leave use_kernels unset for float64")
    if device_type == "cuda" and dtype == torch.float32:
        if use_kernels is False:
            raise ValueError("a float32 CUDA operator always runs the "
                             "kernels")
        return True
    return bool(use_kernels)


class _PackedBase:
    """What every packed-genotype operator shares: the device and dtype,
    the decode constants, the valid-sample mask, the per-SNP sums of
    squares and the two-float code tables.

    Parameters
    ----------
    mean, sd : per-SNP standardization stats (float64, exact).
    n_samples : true N.
    n_snps : p.
    device : ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` runs
        the PyTorch path.
    dtype : float32 (CUDA default, the kernels' type) or float64 (CPU
        default; on CUDA it runs the functional core on the card).
    use_kernels : run the products through kernels/packed_matvec.py; see
        :func:`runs_kernels`.
    snp_sumsq : optional precomputed per-SNP sums of squares (makes
        ``trace`` free).
    mesh : optional 1-D :class:`~flashpca_tpu_torch.parallel.Mesh`; the
        operator's device is then the mesh's first device of this
        process (``device`` may name its type only).
    """

    def __init__(self, mean, sd, n_samples: int, n_snps: int, *,
                 device=None, dtype=None, use_kernels: bool | None = None,
                 snp_sumsq=None, mesh=None):
        self.mesh = mesh
        self.nshards = 1 if mesh is None else mesh.size
        if mesh is not None:
            if device is not None and torch.device(device).type != \
                    mesh.devices[0].type:
                raise ValueError(
                    f"device={device} conflicts with the mesh's devices "
                    f"({mesh.devices[0].type})")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        dtype = as_torch_dtype(dtype) or default_dtype(self.device)
        self.use_kernels = runs_kernels(self.device.type, dtype, use_kernels)
        self.n_samples = int(n_samples)
        self.n_snps = int(n_snps)
        self.nbytes = bytes_per_snp(n_samples)
        self.n4 = self.nbytes * PACK_DENSITY
        self.dtype = dtype
        # exact f64 standardization stats (reported as center/scale)
        self.center = np.asarray(mean, dtype=np.float64)
        self.scale = np.asarray(sd, dtype=np.float64)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        mean_f, invsd_f = lookup_tables(mean, sd, dtype=np_dtype)
        self.mean = torch.as_tensor(mean_f, device=self.device)
        self.invsd = torch.as_tensor(invsd_f, device=self.device)
        self._valid = valid_mask_permuted(n_samples, self.nbytes, dtype,
                                          self.device)
        self._sumsq = _host_sumsq(snp_sumsq, self.n_snps)
        self._trace = None
        self._luts = None
        self.nops = 0

    def _reduced(self, acc, shape):
        """A partial product summed over the mesh's processes (zeros
        when this process holds no shard of it)."""
        if acc is None:
            acc = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return acc if self.mesh is None else self.mesh.all_sum(acc)

    def _pair_reduced(self, pair, shape):
        """A two-float partial pair folded over the mesh's processes."""
        if pair is None:
            z = torch.zeros(shape, dtype=self.dtype, device=self.device)
            pair = (z, z.clone())
        return pair if self.mesh is None else self.mesh.fold_pairs(*pair)

    def _rows(self, parts, total, like):
        """Rows [lo, hi) from each ``parts`` entry (lo, hi, rows),
        assembled to the (total, ...) result on this operator's
        device."""
        if self.mesh is None:
            return (parts[0][2] if len(parts) == 1
                    else torch.cat([r for _, _, r in parts]))
        return self.mesh.gather_rows(parts, total, like, self.device)

    def _as_2d(self, x, length, name):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        vec = x.ndim == 1
        if vec:
            x = x[:, None]
        if x.shape[0] != length:
            raise ValueError(
                f"{name}: expected leading dim {length}, got {x.shape[0]}")
        return x, vec

    @property
    def snp_sumsq(self) -> np.ndarray:
        """Per-SNP sum of squared standardized genotypes (float64 host)."""
        if self._sumsq is None:
            self._sumsq = self._snp_sumsq_dev().to("cpu", torch.float64
                                                   ).numpy()
        return self._sumsq

    @property
    def trace(self) -> float:
        """trace(X X^T) = trace(X^T X) = sum of squares of X
        (svdwide.cpp:44-45)."""
        return float(self.snp_sumsq.sum())

    def _ff_luts(self):
        """Exact two-float code tables (p, 4), built on first use."""
        if self._luts is None:
            from .compensated import code_value_luts

            lh, ll = code_value_luts(self.center, self.scale)
            self._luts = (torch.as_tensor(lh, device=self.device),
                          torch.as_tensor(ll, device=self.device))
        return self._luts


class _ResidentPacked(_PackedBase):
    """What the wide and the tall resident operator share: the packed
    bytes held on the device, or with a ``mesh`` split into this
    process's shards, each on its device, beside :class:`_PackedBase`'s
    constants.

    Parameters
    ----------
    packed : (p, nbytes) uint8, the raw .bed payload (numpy or a torch
        tensor, e.g. generated on the card).  With a ``mesh``, either
        those bytes whole (this process takes its shards of them: row
        slices of a tensor on the shard's device are views) or this
        process's shards as a list, in the padded layout of
        :meth:`plan_layout` (parallel/dist.py's loaders).
    mean, sd, n_samples, device, dtype, use_kernels, snp_sumsq, mesh :
        as :class:`_PackedBase`.
    block_size : SNPs decoded per block on the CPU path (the analog of
        the reference's --blocksize).
    n_snps : p; required when ``packed`` is a list of shards.
    """

    def __init__(self, packed, mean, sd, n_samples: int, *, device=None,
                 dtype=None, block_size: int | None = None,
                 use_kernels: bool | None = None, n_snps: int | None = None,
                 snp_sumsq=None, mesh=None):
        nbytes = bytes_per_snp(n_samples)
        listed = isinstance(packed, (list, tuple))
        if listed and (mesh is None or n_snps is None):
            raise ValueError("a list of shards needs its mesh and n_snps")
        p = int(n_snps) if n_snps is not None else int(packed.shape[0])
        if not listed and tuple(packed.shape) != (p, nbytes):
            raise ValueError(f"packed shape {tuple(packed.shape)} is not "
                             f"the raw ({p}, {nbytes}) layout")
        super().__init__(mean, sd, n_samples, p, device=device, dtype=dtype,
                         use_kernels=use_kernels, snp_sumsq=snp_sumsq,
                         mesh=mesh)
        self.block_size = self.plan_layout(p, nbytes, block_size=block_size,
                                           dtype=self.dtype)["block_size"]
        if mesh is None:
            self.packed = _uint8_on(packed, self.device)
            self._shards = self._whole_shard()
            return
        # the shards hold the bytes; the whole array is not kept
        self.packed = None
        plan = self.plan_layout(p, nbytes, dtype=self.dtype,
                                nshards=mesh.size)
        if listed and len(packed) != len(mesh.devices):
            raise ValueError(f"{len(packed)} shards for this process's "
                             f"{len(mesh.devices)} mesh devices")
        self._shards = []
        for j, (i, dev) in enumerate(mesh.local_shards):
            shard = self._shard(packed[j] if listed else packed, listed,
                                plan, i, dev)
            if shard is not None:
                self._shards.append(shard)
        self._cards = self._shard_constants()

    @classmethod
    def plan_layout(cls, p, nbytes, *, block_size=None, dtype=torch.float64,
                    nshards: int = 1):
        """Layout of (p, nbytes) packed data.  The kernels mask their own
        ragged edges, so one device pads nothing (``p_pad == p``,
        ``nbytes_pad == nbytes``); ``nshards`` rounds the sharded axis up
        to equal shards (the wide operator's rows; the tall one's
        bytes, in whole words).  ``block_size`` is the CPU core's SNPs
        per decoded block (~128 MiB of decoded floats)."""
        if block_size is None:
            itemsize = torch.finfo(dtype).bits // 8
            block_size = max(128, (128 << 20)
                             // (nbytes * PACK_DENSITY * itemsize))
        p_pad, nbytes_pad = cls._padded(int(p), int(nbytes), int(nshards))
        return dict(p_pad=p_pad, nbytes_pad=nbytes_pad,
                    block_size=int(max(1, min(block_size, p))))

    def _shard_constants(self):
        """Each shard's decode constants on its device (PackedOperator),
        or None: the shards then read the home device's."""
        return None

    def stats(self) -> dict:
        """Observability counters: operator products dispatched, packed
        bytes resident, per-pass decode volume, and the operators'
        kernel launches so far (process-wide counts of
        kernels/packed_matvec.py)."""
        from ..kernels.packed_matvec import OPERATOR_KERNELS, launch_counts

        nbytes = self.n_snps * self.nbytes
        itemsize = torch.finfo(self.dtype).bits // 8
        return {
            "nops": self.nops,
            "packed_bytes": nbytes,
            "decoded_gb_per_pass": nbytes * 4 * itemsize / 1e9,
            "use_kernels": self.use_kernels,
            "device": str(self.device),
            "block_size": self.block_size,
            "nshards": self.nshards,
            "kernel_launches": {k: launch_counts[k]
                                for k in OPERATOR_KERNELS},
        }


def _uint8_on(packed, device) -> torch.Tensor:
    """Packed bytes (numpy or a tensor) as a contiguous uint8 tensor on
    ``device``: a contiguous tensor already there is used as it is."""
    if isinstance(packed, torch.Tensor):
        return packed.to(device, torch.uint8).contiguous()
    # np.require copies read-only (memory-mapped) input once
    return torch.from_numpy(
        np.require(packed, np.uint8, ["C", "W"])).to(device)


class _WideProducts:
    """The wide gram's public products (permuted-space interface for the
    eigensolver, sample-space products for the models), written over
    four raw products, each on byte-masked input in permuted sample
    space: ``_gram_raw`` (W^T W xp), ``_cross_raw`` (W xp), ``_mv_raw``
    (W^T v) and ``_ff_raw`` (the two-float W^T W xp).  They run over a
    subclass's parts -- (bytes, lo, hi) for SNP rows [lo, hi) from
    ``_row_parts()``: the resident operator's shards, the streaming
    one's staged blocks -- summing the partials in part order (folding
    two-float pairs) and gathering ``crossprod``'s rows, across a mesh's
    processes too.  ``_budget_rows(rows)`` is the SNP count the
    functional core budgets its decoded blocks by on a part of ``rows``
    SNPs.

    ``_cards`` holds a sharded resident operator's decode constants on
    its shards' devices (None elsewhere); its products then run in three
    phases (:meth:`_partials`) so that the shards' kernels overlap."""

    _cards = None
    xcard_bytes = xcard_copies = 0

    def _consts(self, which, lo, hi, dev):
        """Rows [lo, hi) of the decode constants a product reads, on
        ``dev``: ``"plain"`` (mean, invsd), ``"ff"`` (the two-float code
        tables) or ``"sumsq"`` (mean, invsd and the valid-sample mask)."""
        if which == "ff":
            lut_hi, lut_lo = self._ff_luts()
            return lut_hi[lo:hi].to(dev), lut_lo[lo:hi].to(dev)
        m, iv = self.mean[lo:hi].to(dev), self.invsd[lo:hi].to(dev)
        return (m, iv) if which == "plain" else (m, iv, self._valid.to(dev))

    def _partials(self, which, fn, arg, kc):
        """(lo, hi, partial on this operator's device) for each part, in
        part order: ``fn(blk, lo, hi, consts, x)`` on the part's device,
        ``consts`` its rows of the constants ``which`` and ``x`` the
        part's operand ``arg(lo, hi)`` there (None without ``arg``).

        A sharded resident operator runs three phases: every shard's
        operand is copied to its device, every shard's kernels are
        launched, and then the partials come home.  A copy between cards
        waits for the work queued on both cards' current streams, so a
        shard's operand copied after the earlier shards' kernels would
        hold its card back until they end.  Everywhere else each part is
        one step after another: a streaming operator's staged blocks must
        be consumed in rotation."""
        home = self.device
        if self._cards is None:
            for blk, lo, hi in self._row_parts():
                dev = blk.device
                c = self._consts(which, lo, hi, dev)
                out = fn(blk, lo, hi, c,
                         None if arg is None else arg(lo, hi).to(dev))
                yield lo, hi, _moved(out, home)
            return
        parts = self._row_parts()
        with span("mesh/scatter", kc):
            xs = [None if arg is None else self._xcard(j, arg(lo, hi),
                                                       blk.device)
                  for j, (blk, lo, hi) in enumerate(parts)]
        outs = [fn(blk, lo, hi, c[which], x) for (blk, lo, hi), c, x
                in zip(parts, self._cards, xs)]
        with span("mesh/gather", kc):
            outs = [self._xcard(j, o, home) for j, o in enumerate(outs)]
        for (_, lo, hi), out in zip(parts, outs):
            yield lo, hi, out

    def _xcard(self, j, t, dev):
        """``t`` (a tensor or a pair) moved to ``dev`` by shard ``j``'s
        scatter or gather, counted when ``j`` is not this process's first
        shard (a shard stands for a card of its own, also where the mesh
        repeats a device)."""
        if j:
            for x in (t if isinstance(t, tuple) else (t,)):
                self.xcard_bytes += x.numel() * x.element_size()
                self.xcard_copies += 1
        return _moved(t, dev)

    def _plain(self, name):
        """``fn`` of :meth:`_partials` for the plain product ``name``:
        the kernel wrapper, or the functional core."""
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            kernel = getattr(kpm, name)
            return lambda blk, lo, hi, c, x: kernel(blk, *c, x)
        core = _CORE[name]
        return lambda blk, lo, hi, c, x: core(blk, *c, x,
                                              block_size=self.block_size)

    def _gram_raw(self, xp):
        acc = None
        for _, _, t in self._partials("plain", self._plain("gram_matvec_p"),
                                      lambda lo, hi: xp, width(xp)):
            acc = _acc(acc, t)
        return self._reduced(acc, xp.shape)

    def _cross_raw(self, xp):
        return self._rows(list(self._partials(
            "plain", self._plain("crossprod_p"), lambda lo, hi: xp,
            width(xp))), self.n_snps, xp)

    def _mv_raw(self, v2):
        acc = None
        for _, _, t in self._partials("plain", self._plain("matvec_p"),
                                      lambda lo, hi: v2[lo:hi], width(v2)):
            acc = _acc(acc, t)
        return self._reduced(acc, (self.n4, v2.shape[1]))

    def _ff_raw(self, xp):
        """The parts' two-float grams folded by TwoSum: y_hi's rounding
        error and the parts' own lo halves into y_lo (the JAX package's
        fold, flashpca_tpu/ops/operator.py:1568-1571)."""
        from .compensated import default_chunk, gram_ff_p

        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            def fn(blk, lo, hi, c, x):
                return kpm.gram_ff_p(blk, *c, x)
        else:
            def fn(blk, lo, hi, c, x):
                bs = budget_block_size(self._budget_rows(hi - lo), self.n4,
                                       itemsize=8, cap=default_chunk())
                return gram_ff_p(blk, *c, x, block_size=bs)
        pair = None
        for _, _, t in self._partials("ff", fn, lambda lo, hi: xp,
                                      width(xp)):
            pair = _fold(pair, t)
        return self._pair_reduced(pair, xp.shape)

    def _snp_sumsq_dev(self):
        def fn(blk, lo, hi, c, x):
            return snp_sumsq_p(blk, *c, block_size=budget_block_size(
                self._budget_rows(hi - lo), self.n4))
        return self._rows(list(self._partials("sumsq", fn, None, None)),
                          self.n_snps, self._valid)

    # -- permuted-space interface (used by the eigensolver) ------------------
    @property
    def op_dim(self) -> int:
        """Length of permuted-space vectors."""
        return self.n4

    @property
    def supports_ff(self) -> bool:
        """The wide two-float gram runs on every path (kernels, their
        plain versions, or the float64 functional core)."""
        return True

    def permute(self, x):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        return permute_samples(x, self.nbytes)

    def permute_np(self, x):
        """Host numpy twin of :meth:`permute`."""
        return permute_samples_np(x, self.nbytes)

    def unpermute(self, yp):
        return unpermute_samples(yp, self.n_samples)

    # -- raw products (permuted space, masked) -------------------------------
    def _gram_p(self, xp):
        with span("op/gram", width(xp)):
            v = self._valid[:, None]
            return self._gram_raw(xp * v).to(self.dtype) * v

    def _cross_p(self, xp):
        with span("op/cross", width(xp)):
            return self._cross_raw(xp * self._valid[:, None]).to(
                self.dtype)

    def _mv_p(self, v2):
        with span("op/prod", width(v2)):
            return self._mv_raw(v2).to(self.dtype) * self._valid[:, None]

    def gram_permuted(self, xp):
        """yp = X X^T xp in permuted space; (n4,) or (n4, k) -> same.
        Byte-padding positions are masked to exactly zero."""
        vec = xp.ndim == 1
        yp = self._gram_p(xp[:, None] if vec else xp)
        self.nops += 1
        return yp[:, 0] if vec else yp

    # -- public products (sample space) --------------------------------------
    def perform_op(self, x):
        """y = X X^T x; x is (N,) or (N, k)."""
        x2, vec = self._as_2d(x, self.n_samples, "perform_op")
        yp = self._gram_p(permute_samples(x2, self.nbytes))
        self.nops += 1
        y = unpermute_samples(yp, self.n_samples)
        return y[:, 0] if vec else y

    def crossprod(self, x):
        """z = X^T x; x is (N,) or (N, k) -> (p,) or (p, k)."""
        x2, vec = self._as_2d(x, self.n_samples, "crossprod")
        z = self._cross_p(permute_samples(x2, self.nbytes))
        self.nops += 1
        return z[:, 0] if vec else z

    def prod(self, v):
        """y = X v; v is (p,) or (p, k) -> (N,) or (N, k)."""
        v2, vec = self._as_2d(v, self.n_snps, "prod")
        yp = self._mv_p(v2)
        self.nops += 1
        y = unpermute_samples(yp, self.n_samples)
        return y[:, 0] if vec else y

    # -- compensated (two-float) product -------------------------------------
    def gram_ff_permuted(self, xp):
        """(y_hi, y_lo) two-float pair of X X^T xp, permuted space: the
        float64-grade product behind the contract polish and check()."""
        vec = xp.ndim == 1
        xp2 = (xp[:, None] if vec else xp).to(self.dtype)
        v = self._valid[:, None]
        with span("op/gram_ff", width(xp2)):
            hi, lo = self._ff_raw(xp2 * v)
            hi, lo = hi * v, lo * v
        self.nops += 1
        return (hi[:, 0], lo[:, 0]) if vec else (hi, lo)

    def perform_op_ff(self, x):
        """Sample-space twin of :meth:`gram_ff_permuted`."""
        x2, vec = self._as_2d(x, self.n_samples, "perform_op_ff")
        hi, lo = self.gram_ff_permuted(permute_samples(x2, self.nbytes))
        hi = unpermute_samples(hi, self.n_samples)
        lo = unpermute_samples(lo, self.n_samples)
        return (hi[:, 0], lo[:, 0]) if vec else (hi, lo)


class PackedOperator(_WideProducts, _ResidentPacked):
    """Device-resident packed-genotype operator for the wide gram
    X X^T; parameters as :class:`_ResidentPacked`.  With a mesh the SNP
    rows are sharded: each shard computes its partial gram
    ``W_s^T (W_s xp)`` and ``prod`` partial ``W_s^T v_s``, summed over
    the shards, while ``crossprod``'s rows are gathered."""

    @staticmethod
    def _padded(p, nbytes, nshards):
        return -(-p // nshards) * nshards, nbytes

    def _whole_shard(self):
        return [(self.packed, 0, self.n_snps)]

    def _shard(self, src, listed, plan, i, dev):
        """Shard ``i``'s (bytes on ``dev``, lo, hi): SNP rows [lo, hi) of
        the equal row ranges, None when it holds only padding rows."""
        from ..parallel.dist import plan_row_shards

        start, stop = plan_row_shards(plan["p_pad"], self.nshards)[i]
        lo, hi = min(start, self.n_snps), min(stop, self.n_snps)
        if hi <= lo:
            return None
        if listed:
            if tuple(src.shape) != (stop - start, self.nbytes):
                raise ValueError(
                    f"shard {i} has shape {tuple(src.shape)}, not "
                    f"({stop - start}, {self.nbytes})")
            rows = src[: hi - lo]
        else:
            rows = src[lo:hi]
        return _uint8_on(rows, dev), lo, hi

    def _row_parts(self):
        return self._shards

    def _budget_rows(self, rows):
        return rows

    def _shard_constants(self):
        """Each shard's rows of mean and invsd, of the two-float code
        tables, and the valid-sample mask, made on its device once, from
        the host: constants, which no product then copies."""
        from .compensated import code_value_luts

        mean, invsd = self.mean.cpu(), self.invsd.cpu()
        lut_hi, lut_lo = (torch.from_numpy(t) for t in
                          code_value_luts(self.center, self.scale))
        cards = []
        for blk, lo, hi in self._shards:
            dev = blk.device
            m, iv = mean[lo:hi].to(dev), invsd[lo:hi].to(dev)
            cards.append({"plain": (m, iv),
                          "ff": (lut_hi[lo:hi].to(dev),
                                 lut_lo[lo:hi].to(dev)),
                          "sumsq": (m, iv, valid_mask_permuted(
                              self.n_samples, self.nbytes, self.dtype,
                              dev))})
        return cards

    def stats(self) -> dict:
        """:meth:`_ResidentPacked.stats`, and the bytes and copies that
        the sharded products moved between a shard's card and the home
        card since the operator was built (``xcard_bytes``,
        ``xcard_copies``; 0 with one shard)."""
        return super().stats() | {"xcard_bytes": self.xcard_bytes,
                                  "xcard_copies": self.xcard_copies}


_CORE = {"gram_matvec_p": gram_matvec_p, "crossprod_p": crossprod_p,
         "matvec_p": matvec_p}


class _SnpSpace:
    """The tall gram X^T X's products, shared by the resident and the
    streaming tall operator: the solver works in SNP space, which needs
    no permutation and no padding (``op_dim = p``).  One gram pass is
    y = X v over the samples (B2), the byte-padding sample positions
    zeroed, then X^T y (B1); the two-float gram is B5, the mask, then B3
    plus B1 on the low half.  ``_mv``, ``_gram`` and ``_gram_ff`` run
    them on (p, w) packed bytes and the (4 w,) valid-sample mask of
    those w bytes, on the bytes' device.

    A subclass yields its parts -- (bytes, mask, lo, hi) for byte
    columns [lo, hi) -- from ``_parts()``: the resident operator its
    shards, the streaming one its staged blocks.  The gram sums the
    parts' partials, the two-float gram folds them, ``prod`` gathers
    their runs of samples; across a mesh's processes likewise."""

    @property
    def op_dim(self) -> int:
        return self.n_snps

    def permute(self, v):
        return torch.as_tensor(v, device=self.device).to(self.dtype)

    def permute_np(self, v):
        """Host-side twin of :meth:`permute` (numpy in/out)."""
        return np.asarray(v)

    def unpermute(self, u):
        return u[: self.n_snps]

    @property
    def supports_ff(self) -> bool:
        """The tall two-float gram runs through the kernel wrappers only
        (the functional core has no tall composition): at float32 on
        CUDA, or on the CPU with ``use_kernels=True`` (their plain
        versions); a float64 operator, on either device, has none."""
        return self.use_kernels

    def _mv(self, packed, v2, valid):
        """y = W^T v in permuted sample space, byte padding zeroed."""
        dev = packed.device
        m, iv, v2 = self.mean.to(dev), self.invsd.to(dev), v2.to(dev)
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            y = kpm.matvec_p(packed, m, iv, v2)
        else:
            y = matvec_p(packed, m, iv, v2, block_size=self.block_size)
        return y.to(self.dtype) * valid[:, None]

    def _cross(self, packed, xp):
        """z = W xp, xp in the bytes' permuted sample layout (B1)."""
        dev = packed.device
        m, iv = self.mean.to(dev), self.invsd.to(dev)
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            return kpm.crossprod_p(packed, m, iv, xp).to(self.dtype)
        return crossprod_p(packed, m, iv, xp, block_size=self.block_size)

    def _gram(self, packed, v2, valid):
        """u = W M W^T v, M = diag(valid)."""
        return self._cross(packed, self._mv(packed, v2, valid))

    def _gram_ff(self, packed, v2, valid):
        """(z_hi, z_lo) two-float pair of W M W^T v."""
        if not self.use_kernels:
            raise NotImplementedError(
                "the tall two-float gram needs the kernel wrappers "
                "(a float32 CUDA operator, or use_kernels=True on the "
                "CPU)")
        from ..kernels import packed_matvec as kpm

        dev = packed.device
        lut_hi, lut_lo = self._ff_luts()
        return kpm.gram_tall_ff_p(packed, lut_hi.to(dev), lut_lo.to(dev),
                                  self.mean.to(dev), self.invsd.to(dev),
                                  v2.to(dev), valid)

    # -- products over the parts ---------------------------------------------
    def gram_permuted(self, v):
        """u = X^T X v in SNP space; (p,) or (p, k) -> same."""
        vec = v.ndim == 1
        v2 = v[:, None] if vec else v
        acc = None
        with span("op/gram", width(v2)):
            for blk, valid, _, _ in self._parts():
                acc = _acc(acc, self._gram(blk, v2, valid).to(self.device))
            acc = self._reduced(acc, v2.shape)
        self.nops += 1
        return acc[:, 0] if vec else acc

    def prod(self, v):
        """y = X v: (p,) or (p, k) -> (N,) or (N, k), natural order."""
        v2, vec = self._as_2d(v, self.n_snps, "prod")
        with span("op/prod", width(v2)):
            segs = [(PACK_DENSITY * lo, PACK_DENSITY * hi,
                     unpermute_samples(self._mv(blk, v2, valid),
                                       PACK_DENSITY * (hi - lo)))
                    for blk, valid, lo, hi in self._parts()]
            y = self._rows(segs, PACK_DENSITY * self._bytes_total,
                           v2)[: self.n_samples]
        self.nops += 1
        return y[:, 0] if vec else y

    def gram_ff_permuted(self, v):
        """(z_hi, z_lo) two-float pair of X^T X v in SNP space: each
        part's pair folded in by TwoSum, its error and the part's own lo
        half into z_lo (the JAX package's fold,
        flashpca_tpu/ops/operator.py:2030-2033)."""
        vec = v.ndim == 1
        v2 = (v[:, None] if vec else v).to(self.dtype)
        pair = None
        with span("op/gram_ff", width(v2)):
            for blk, valid, _, _ in self._parts():
                t_hi, t_err = self._gram_ff(blk, v2, valid)
                pair = _fold(pair, (t_hi.to(self.device),
                                    t_err.to(self.device)))
            hi, lo = self._pair_reduced(pair, v2.shape)
        self.nops += 1
        return (hi[:, 0], lo[:, 0]) if vec else (hi, lo)

    @property
    def snp_sumsq(self) -> np.ndarray:
        """Per-SNP sums of squares, the parts' partials summed in host
        float64 (float32 sums across many parts would leak ~1e-6
        relative into trace and pve)."""
        if self._sumsq is None:
            tot = np.zeros(self.n_snps)
            for blk, valid, lo, hi in self._parts():
                dev = blk.device
                tot += snp_sumsq_p(
                    blk, self.mean.to(dev), self.invsd.to(dev), valid,
                    block_size=self._sumsq_block(hi - lo)).to(
                        "cpu", torch.float64).numpy()
            if self.mesh is not None:
                tot = self.mesh.all_sum(torch.from_numpy(tot)).numpy()
            self._sumsq = tot
        return self._sumsq


class TallPackedOperator(_SnpSpace, _ResidentPacked):
    """Tall-path operator: the eigenproblem is the p x p gram ``X^T X``
    (right singular vectors), for the n >> p regime, with the packed
    bytes on the device; parameters as :class:`_ResidentPacked`,
    products as :class:`_SnpSpace`.  With a mesh the byte columns
    (samples) are sharded, each shard with its own valid-sample mask."""

    @staticmethod
    def _padded(p, nbytes, nshards):
        if nshards == 1:
            return p, nbytes
        unit = PACK_DENSITY * nshards          # whole words a shard
        return p, -(-nbytes // unit) * unit

    @property
    def _bytes_total(self):
        return self.plan_layout(self.n_snps, self.nbytes,
                                nshards=self.nshards)["nbytes_pad"]

    def _whole_shard(self):
        return [(self.packed, self._valid, 0, self.nbytes)]

    def _shard(self, src, listed, plan, i, dev):
        """Shard ``i``'s (bytes on ``dev``, mask, lo, hi): byte columns
        [lo, hi) of the equal ranges, None when they are all padding; a
        listed shard keeps its padding bytes, which its mask zeroes."""
        from ..parallel.dist import plan_byte_shards

        lo, hi = plan_byte_shards(plan["nbytes_pad"], self.nshards)[i]
        if min(hi, self.nbytes) <= lo:
            return None
        if listed:
            if tuple(src.shape) != (plan["p_pad"], hi - lo):
                raise ValueError(
                    f"shard {i} has shape {tuple(src.shape)}, not "
                    f"({plan['p_pad']}, {hi - lo})")
            cols = src[: self.n_snps]
        else:
            hi = min(hi, self.nbytes)
            cols = src[:, lo:hi]
            cols = (cols.contiguous() if isinstance(cols, torch.Tensor)
                    else np.ascontiguousarray(cols))
        blk = _uint8_on(cols, dev)
        return (blk, window_valid(self.n_samples, lo, blk.shape[1],
                                  self.dtype, dev), lo, lo + blk.shape[1])

    def _parts(self):
        return self._shards

    def _sumsq_block(self, width):
        return budget_block_size(self.n_snps, PACK_DENSITY * width)


def _host_source(source, n_samples: int) -> np.ndarray:
    """The (p, nbytes) uint8 bytes a streaming operator stages from: a
    :class:`PlinkDataset`'s memmap (read block by block) or an array,
    used as it is."""
    from ..io.plink import PlinkDataset

    packed = (source._map() if isinstance(source, PlinkDataset)
              else np.asarray(source))
    if packed.ndim != 2 or packed.dtype != np.uint8:
        raise ValueError(f"source must be (p, nbytes) uint8, got "
                         f"{packed.dtype} {packed.shape}")
    if packed.shape[1] != bytes_per_snp(n_samples):
        raise ValueError("packed width does not match n_samples")
    return packed


class _StagedBlocks:
    """The staging rotation both streaming operators share: the packed
    bytes stay on the HOST (a numpy array or a .bed memmap) and reach the
    device one block at a time, so device memory holds two block buffers
    whatever the cohort's size.

    A subclass says what a block is: ``_items``, each block's range
    [lo, hi) on the blocked axis and the device it runs on (with a mesh,
    each block is split into one item a shard, of which this process
    stages its own); ``_block_shape(lo, hi)``, its (SNPs, bytes) on the
    device; and ``_host_block(lo, hi)``, the host slice it copies.  The
    buffers hold ``block_nbytes`` bytes, a full item; a shorter one runs
    on a contiguous prefix of them (the kernels take contiguous bytes
    only).

    Staging on CUDA: two pinned host buffers and two device buffers
    rotate; a side stream makes the host-to-device copies.  The compute
    stream waits on "block j copied" before its kernels read buffer j;
    the copy stream waits on "block j's kernels done" before it
    overwrites buffer j; the host waits on "block j copied" before it
    refills pinned buffer j.  ``cache_mb``: the first blocks that fit
    this many MB stay on the device after their first staging, and
    later products stage only the rest (a pinned prefix, not an LRU:
    products scan the blocks cyclically, and an LRU smaller than the
    data never hits); ``"auto"``: on CUDA half the card's memory less
    the two block buffers, unless ``memory_mb`` bounds the device; 0 on
    the CPU.  ``prefetch``: fill the next block's host buffer on a
    worker thread while the current block is copied and computed
    (default: on CUDA).  The copies and kernels are asynchronous, so the
    main thread's own fill overlaps them already; the worker adds a
    second fill at the start of each pass, which the host's memcpy rate
    makes worth a few percent of a pass (PERF.md).
    """

    def _split_blocks(self, extent: int, block: int, unit: int):
        """(block, items): the block length rounded to whole ``unit``s a
        shard, and [lo, hi, device] of this process's items -- each
        block of the axis [0, extent) split into equal shard ranges
        (the whole block, on the operator's device, without a mesh)."""
        if self.mesh is None:
            return block, [(lo, min(lo + block, extent), self.device)
                           for lo in range(0, extent, block)]
        step = max(unit, block // self.nshards // unit * unit)
        block = step * self.nshards
        items = []
        for b0 in range(0, extent, block):
            b1 = min(b0 + block, extent)
            for i, dev in self.mesh.local_shards:
                lo = b0 + i * step
                if lo < b1:
                    items.append((lo, min(lo + step, b1), dev))
        return block, items

    def _bounds(self, i: int):
        return self._items[i][:2]

    def _staged(self):
        """(block on its item's device, lo, hi) for every item in order."""
        for i, (blk, lo, hi) in enumerate(self._blocks()):
            yield blk.to(self._items[i][2]), lo, hi

    def _init_staging(self, packed, *, n_blocks: int, block_nbytes: int,
                      memory_mb, cache_mb, prefetch):
        self._host_packed = packed
        self.n_blocks = int(n_blocks)
        self.block_nbytes = int(block_nbytes)
        self._memory_bounded = memory_mb is not None
        self.cache_mb = cache_mb
        self._cache: dict = {}
        self._n_cached: int | None = None
        self.staged_host_blocks = 0
        self._prefetch = (self.device.type == "cuda" if prefetch is None
                          else bool(prefetch))
        self._pool = None
        self._stage_stats = dict.fromkeys(
            ("fill_s", "put_s", "sync_s", "wait_s"), 0.0)
        self._stage_stats["staged_bytes"] = 0
        # the two-buffer rotation: host staging buffers (pinned on CUDA),
        # device buffers, the copy stream and the slot events; allocated
        # on the first staged block.  ``_seq`` counts staged blocks
        # across products, so back-to-back products alternate slots.
        self._host = [None, None]
        self._dev = [None, None]
        self._seq = 0
        self._copy_stream = None
        self._copied = self._consumed = None

    def _resolve_cache_blocks(self) -> int:
        """Number of leading blocks kept on the device (``cache_mb``)."""
        if self._n_cached is None:
            block_bytes = self.block_nbytes
            if not self.cache_mb:
                n = 0
            elif self.cache_mb == "auto":
                n = 0
                # an explicit memory_mb means the caller capped device
                # memory at two block buffers; caching beyond it would
                # break that bound (pass cache_mb to combine the two)
                if self.device.type == "cuda" and not self._memory_bounded:
                    total = torch.cuda.mem_get_info(self.device)[1]
                    n = max(0, (total // 2 - 2 * block_bytes) // block_bytes)
            else:
                n = (int(self.cache_mb) << 20) // block_bytes
            self._n_cached = int(min(n, self.n_blocks))
        return self._n_cached

    def _view(self, buf, lo: int, hi: int):
        """Block [lo, hi)'s contiguous (SNPs, bytes) view of a buffer."""
        rows, cols = self._block_shape(lo, hi)
        return buf[: rows * cols].view(rows, cols)

    def _alloc_staging(self):
        """The rotation's buffers and events, on the first staged block."""
        if self._host[0] is not None:
            return
        if self.device.type == "cuda":
            self._host = [torch.empty(self.block_nbytes, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._consumed = [torch.cuda.Event() for _ in range(2)]
        else:
            self._host = [torch.from_numpy(np.empty(self.block_nbytes,
                                                    np.uint8))
                          for _ in range(2)]

    def _prep_host_block(self, i: int, j: int):
        """Fill host buffer ``j`` with block ``i``'s packed bytes, once
        the copy that last read it has drained; returns (seconds waiting
        for that copy, seconds filling).  Host work only (numpy and the
        source's reads), so it is safe on the prefetch thread."""
        lo, hi = self._bounds(i)
        t0 = time.perf_counter()
        if self._copied is not None:
            self._copied[j].synchronize()
        t1 = time.perf_counter()
        np.copyto(self._view(self._host[j], lo, hi).numpy(),
                  self._host_block(lo, hi))
        return t1 - t0, time.perf_counter() - t1

    def _put(self, i: int, j: int, pin: bool):
        """Block ``i`` from host buffer ``j`` on the device: a copy on the
        side stream into device buffer ``j`` (or, for a cached block, a
        buffer of its own) that the compute stream waits on; on the CPU
        the host buffer itself (a cached block: a copy of it)."""
        lo, hi = self._bounds(i)
        src = self._view(self._host[j], lo, hi)
        if self.device.type != "cuda":
            return src.clone() if pin else src
        cs = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        fresh = pin or self._dev[j] is None
        if pin:
            dst = torch.empty_like(src, device=self.device)
        else:
            if self._dev[j] is None:
                self._dev[j] = torch.empty(self.block_nbytes,
                                           dtype=torch.uint8,
                                           device=self.device)
            dst = self._view(self._dev[j], lo, hi)
        if fresh:
            # the caching allocator hands the compute stream memory that
            # its queued kernels may still use: the copy follows them
            cs.wait_stream(compute)
        else:
            # device buffer j is rewritten only once its last kernels ran
            cs.wait_event(self._consumed[j])
        with torch.cuda.stream(cs):
            dst.copy_(src, non_blocking=True)
        self._copied[j].record(cs)
        compute.wait_event(self._copied[j])
        return dst

    def _next_streamed(self, i: int) -> int:
        while i < self.n_blocks and i in self._cache:
            i += 1
        return i

    def _blocks(self):
        """Yield (packed block on the device, lo, hi) for every block in
        order: cached blocks from the device, the others staged through
        the two-buffer rotation."""
        n_cached = self._resolve_cache_blocks()
        st = self._stage_stats
        pending: dict = {}
        try:
            for i in range(self.n_blocks):
                lo, hi = self._bounds(i)
                if i in self._cache:
                    yield self._cache[i], lo, hi
                    continue
                self._alloc_staging()
                j = self._seq % 2
                fut = pending.pop(i, None)
                if self._prefetch:
                    # keep the worker one block ahead, in the other slot
                    nxt = self._next_streamed(i + 1)
                    if nxt < self.n_blocks:
                        pending[nxt] = self._worker().submit(
                            self._prep_host_block, nxt, 1 - j)
                if fut is None:
                    sync_s, fill_s = self._prep_host_block(i, j)
                else:
                    t0 = time.perf_counter()
                    sync_s, fill_s = fut.result()
                    st["wait_s"] += time.perf_counter() - t0
                st["sync_s"] += sync_s
                st["fill_s"] += fill_s
                rows, cols = self._block_shape(lo, hi)
                st["staged_bytes"] += rows * cols
                pin = i < n_cached
                t0 = time.perf_counter()
                blk = self._put(i, j, pin)
                st["put_s"] += time.perf_counter() - t0
                self._seq += 1
                self.staged_host_blocks += 1
                if pin:
                    self._cache[i] = blk
                try:
                    yield blk, lo, hi
                finally:
                    if self._consumed is not None:
                        self._consumed[j].record(
                            torch.cuda.current_stream(self.device))
        finally:
            # a product that stopped early leaves no fill running into a
            # buffer the next product will use
            for fut in pending.values():
                if not fut.cancel():
                    fut.exception()

    def _worker(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="flashpca-stage")
        return self._pool

    def close(self) -> None:
        """Release the prefetch worker, the staging buffers and the block
        cache (idempotent; the operator stays usable and allocates them
        again on its next product)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
            torch.cuda.current_stream(self.device).synchronize()
        self._host = [None, None]
        self._dev = [None, None]
        self._cache.clear()
        self._copy_stream = None
        self._copied = self._consumed = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass

    def stats(self) -> dict:
        """Staging counters since the last :meth:`reset_stats`: seconds of
        host fill (``fill_s``), of enqueueing the copies (``put_s``), of
        the host waiting for a copy to drain before refilling its buffer
        (``sync_s``) and of waiting for the prefetch worker (``wait_s``);
        bytes and blocks staged from the host; products; and the
        geometry: blocks, cached blocks, bytes a block, packed bytes, and
        the packed bytes now held on the device (``device_bytes``: the
        device buffers and the cached blocks)."""
        s = dict(self._stage_stats)
        s.update(
            nops=self.nops,
            staged_host_blocks=self.staged_host_blocks,
            n_blocks=self.n_blocks,
            n_cached=self._resolve_cache_blocks(),
            block_bytes=self.block_nbytes,
            packed_bytes=self.n_snps * self.nbytes,
            device_bytes=(sum(t.numel() for t in self._dev if t is not None)
                          + sum(t.numel() for t in self._cache.values())
                          if self.device.type == "cuda" else 0),
            prefetch=self._prefetch,
        )
        return s

    def reset_stats(self) -> None:
        """Zero the cumulative counters (the cache is kept)."""
        self.nops = 0
        self.staged_host_blocks = 0
        for k in self._stage_stats:
            self._stage_stats[k] = 0


class StreamingPackedOperator(_WideProducts, _StagedBlocks, _PackedBase):
    """Bounded-device-memory operator for the wide gram X X^T: the packed
    genotypes stay on the host and stream to the device in blocks of SNP
    rows during each product (:class:`_StagedBlocks`) -- the analog of
    the reference's disk-streaming ``SVDWideOnline``
    (svdwide.cpp:21-68), with the host->device boundary in place of
    disk->RAM.  Device memory holds two block buffers whatever p is, so
    a cohort larger than the card still runs on one card.

    Parameters
    ----------
    source : a :class:`PlinkDataset` (read through its memmap) or a
        (p, nbytes) uint8 array, used as it is.
    mean, sd, n_samples, device, dtype, use_kernels, snp_sumsq : as
        :class:`_PackedBase`.
    block_snps : SNPs per staged block.  Default: ``memory_mb`` read as
        two packed block buffers on the device, ``(memory_mb << 20) //
        (2 * nbytes)``; without it blocks of about 1 GiB.  The last
        block is shorter and runs on the leading rows of its buffer.
    memory_mb : the device budget of the two block buffers (the CLI's
        ``--memory``); it also turns the automatic block cache off.
    cache_mb, prefetch : as :class:`_StagedBlocks`.
    mesh : optional; each block's SNP rows are split into equal shard
        ranges (``block_snps`` rounded down to a multiple of the shard
        count), this process stages its own, and each device's buffers
        hold one shard's part: block / shards.

    The products run the same kernels (B1 + B2, and B3 + B4 in
    two-float) as :class:`PackedOperator`, once per block, on the
    block's rows of the decode constants; the per-block results are
    summed in block order (two-float ones folded with TwoSum), so they
    differ from the resident sums in the last bits, while ``crossprod``
    rows are the resident ones bit for bit.
    """

    def __init__(self, source, mean, sd, n_samples: int, *,
                 block_snps: int | None = None, memory_mb: int | None = None,
                 dtype=None, snp_sumsq=None, cache_mb="auto",
                 prefetch: bool | None = None, device=None,
                 use_kernels: bool | None = None, mesh=None):
        packed = _host_source(source, n_samples)
        p = packed.shape[0]
        super().__init__(mean, sd, n_samples, p, device=device, dtype=dtype,
                         use_kernels=use_kernels, snp_sumsq=snp_sumsq,
                         mesh=mesh)
        if block_snps is None:
            if memory_mb is not None:
                # --memory semantics: two packed block buffers on device
                block_snps = (int(memory_mb) << 20) // (2 * self.nbytes)
            else:
                block_snps = (1 << 30) // self.nbytes          # ~1 GiB
        block, self._items = self._split_blocks(
            p, int(max(1, min(block_snps, p))), 1)
        self.block_snps = block
        # SNP rows of one staged item (a block, or a shard's part of it)
        rows = block // self.nshards
        self._init_staging(packed, n_blocks=len(self._items),
                           block_nbytes=rows * self.nbytes,
                           memory_mb=memory_mb, cache_mb=cache_mb,
                           prefetch=prefetch)
        # the functional core's decode blocks inside a staged item
        self.block_size = budget_block_size(rows, self.n4, cap=8192)

    # -- what a block is: a range of SNP rows --------------------------------
    def _block_shape(self, lo: int, hi: int):
        return hi - lo, self.nbytes

    def _host_block(self, lo: int, hi: int):
        return self._host_packed[lo:hi]


    def _row_parts(self):
        return self._staged()

    def _budget_rows(self, rows):
        # every block's decode budget is a full block's, whatever its rows
        return self.block_snps // self.nshards


class TallStreamingOperator(_SnpSpace, _StagedBlocks, _PackedBase):
    """Bounded-device-memory operator for the tall gram X^T X: the packed
    genotypes stay on the host and stream to the device in blocks of
    byte columns, that is of samples (:class:`_StagedBlocks`), so an
    n >> p cohort larger than the card keeps the p x p problem shape
    (the wide streaming operator's n x n iterate is the wrong problem at
    that scale).  The JAX package's ``TallStreamingOperator``.

    Parameters
    ----------
    source : a :class:`PlinkDataset` (read through its memmap) or a
        (p, nbytes) uint8 array, used as it is.  A block is a strided
        window of every SNP row, so a fill from a memmap makes p short
        reads.
    mean, sd, n_samples, device, dtype, use_kernels, snp_sumsq : as
        :class:`_PackedBase`.
    block_bytes : byte columns (4 samples each) per staged block, rounded
        down to a multiple of 4 (at least 4) and capped at the row width.
        Default: ``memory_mb`` read as two packed block buffers on the
        device, ``(memory_mb << 20) // (2 * p)``; without it blocks of
        about 1 GiB.  The last block is narrower and runs on a
        contiguous prefix of its buffer.
    memory_mb : the device budget of the two block buffers; it also
        turns the automatic block cache off.
    cache_mb, prefetch : as :class:`_StagedBlocks`.
    mesh : optional; each block's byte columns are split into equal
        shard windows (whole words each), this process stages its own,
        and each device's buffers hold one shard's part.

    Per block, on all p rows of the decode constants: the gram adds X_b^T
    (M_b X_b v) (B2, the block's valid-sample mask M_b, B1), the
    two-float gram folds the block's B5, mask, B3 + B1 pair in by TwoSum,
    ``prod`` un-permutes the block's masked B2 into its run of samples,
    and ``crossprod`` adds B1 of the block's masked run of x.  The
    partials are summed in block order, so they differ from the resident
    sums in the last bits.
    """

    def __init__(self, source, mean, sd, n_samples: int, *,
                 block_bytes: int | None = None,
                 memory_mb: int | None = None, dtype=None, snp_sumsq=None,
                 cache_mb="auto", prefetch: bool | None = None, device=None,
                 use_kernels: bool | None = None, mesh=None):
        packed = _host_source(source, n_samples)
        p = packed.shape[0]
        super().__init__(mean, sd, n_samples, p, device=device, dtype=dtype,
                         use_kernels=use_kernels, snp_sumsq=snp_sumsq,
                         mesh=mesh)
        if block_bytes is None:
            if memory_mb is not None:
                # --memory semantics: two packed block buffers on device
                block_bytes = (int(memory_mb) << 20) // (2 * p)
            else:
                block_bytes = (1 << 30) // p                   # ~1 GiB
        # whole bytes of 4 samples, in whole words (the JAX package's
        # rule on its jnp path)
        block_bytes = int(max(PACK_DENSITY, min(block_bytes, self.nbytes)
                              // PACK_DENSITY * PACK_DENSITY))
        self.block_bytes, self._items = self._split_blocks(
            self.nbytes, block_bytes, PACK_DENSITY)
        # byte columns of one staged item (a block, or a shard's part)
        self._item_bytes = self.block_bytes // self.nshards
        self._init_staging(packed, n_blocks=len(self._items),
                           block_nbytes=p * self._item_bytes,
                           memory_mb=memory_mb, cache_mb=cache_mb,
                           prefetch=prefetch)
        # the functional core's decode blocks inside a staged item
        self.block_size = budget_block_size(p, PACK_DENSITY
                                            * self._item_bytes, cap=8192)
        # each item's valid-sample mask in its permuted layout
        self._block_valid = [window_valid(n_samples, lo, hi - lo,
                                          self.dtype, dev)
                             for lo, hi, dev in self._items]

    # -- what a block is: a range of byte columns ----------------------------
    def _block_shape(self, lo: int, hi: int):
        return self.n_snps, hi - lo

    def _host_block(self, lo: int, hi: int):
        return self._host_packed[:, lo:hi]

    @property
    def _bytes_total(self):
        return self.nbytes

    def _parts(self):
        """(block on its device, its valid-sample mask, lo, hi)."""
        for i, (blk, lo, hi) in enumerate(self._staged()):
            yield blk, self._block_valid[i], lo, hi

    def _sumsq_block(self, width):
        return budget_block_size(self.n_snps,
                                 PACK_DENSITY * self._item_bytes)

    def crossprod(self, x):
        """z = X^T x: (N,) or (N, k) -> (p,) or (p, k), natural SNP order
        (the JAX package's ``TallStreamingOperator.crossprod``).  Each
        staged item takes x's run of samples [4 lo, 4 hi), zero past
        ``n_samples``, in its permuted layout and masked, through B1; the
        partials are summed in block order, then over a mesh's
        processes."""
        x2, vec = self._as_2d(x, self.n_samples, "crossprod")
        acc = None
        with span("op/cross", width(x2)):
            for blk, valid, lo, hi in self._parts():
                seg = x2[PACK_DENSITY * lo: PACK_DENSITY * hi].to(
                    blk.device)
                xp = permute_samples(seg, hi - lo) * valid[:, None]
                acc = _acc(acc, self._cross(blk, xp).to(self.device))
            acc = self._reduced(acc, (self.n_snps, x2.shape[1]))
        self.nops += 1
        return acc[:, 0] if vec else acc


def packed_operator_from_numpy(packed, mean, sd, n_samples: int, *,
                               snp_sumsq=None, device=None, dtype=None,
                               **kw) -> PackedOperator:
    """Build the port's operator from the numpy arrays the JAX
    ``PackedOperator`` holds: raw ``(p, nbytes)`` bytes and the float64
    center and scale (the state carried across from the JAX package)."""
    return PackedOperator(np.asarray(packed, dtype=np.uint8),
                          np.asarray(mean, dtype=np.float64),
                          np.asarray(sd, dtype=np.float64), int(n_samples),
                          snp_sumsq=snp_sumsq, device=device, dtype=dtype,
                          **kw)


def tall_operator_from_numpy(packed, mean, sd, n_samples: int, *,
                             snp_sumsq=None, device=None, dtype=None,
                             **kw) -> TallPackedOperator:
    """The tall twin of :func:`packed_operator_from_numpy`: the port's
    ``TallPackedOperator`` from the numpy state of the JAX one (raw
    bytes, float64 center and scale)."""
    return TallPackedOperator(np.asarray(packed, dtype=np.uint8),
                              np.asarray(mean, dtype=np.float64),
                              np.asarray(sd, dtype=np.float64),
                              int(n_samples), snp_sumsq=snp_sumsq,
                              device=device, dtype=dtype, **kw)


def streaming_operator_from_numpy(packed, mean, sd, n_samples: int, *,
                                  block_snps: int | None = None,
                                  snp_sumsq=None, device=None, dtype=None,
                                  **kw) -> StreamingPackedOperator:
    """The streaming twin of :func:`packed_operator_from_numpy`: the
    port's ``StreamingPackedOperator`` from the numpy state of the JAX
    one (its host bytes ``_host_packed``, float64 ``center`` and
    ``scale``, ``n_samples`` and ``block_snps``)."""
    return StreamingPackedOperator(np.asarray(packed, dtype=np.uint8),
                                   np.asarray(mean, dtype=np.float64),
                                   np.asarray(sd, dtype=np.float64),
                                   int(n_samples), block_snps=block_snps,
                                   snp_sumsq=snp_sumsq, device=device,
                                   dtype=dtype, **kw)


def tall_streaming_operator_from_numpy(packed, mean, sd, n_samples: int, *,
                                       block_bytes: int | None = None,
                                       snp_sumsq=None, device=None,
                                       dtype=None, **kw
                                       ) -> TallStreamingOperator:
    """The tall streaming twin of :func:`packed_operator_from_numpy`: the
    port's ``TallStreamingOperator`` from the numpy state of the JAX one
    (its host bytes ``_host_packed``, float64 ``center`` and ``scale``,
    ``n_samples`` and ``block_bytes``)."""
    return TallStreamingOperator(np.asarray(packed, dtype=np.uint8),
                                 np.asarray(mean, dtype=np.float64),
                                 np.asarray(sd, dtype=np.float64),
                                 int(n_samples), block_bytes=block_bytes,
                                 snp_sumsq=snp_sumsq, device=device,
                                 dtype=dtype, **kw)



# ---------------------------------------------------------------------------
# Dense matrix operator
# ---------------------------------------------------------------------------

# float64 bytes of one row chunk when summing squares of a dense X
_SUMSQ_CHUNK_BYTES = 256 << 20


class DenseOperator:
    """Operator over a standardized dense matrix X (N samples x p SNPs)
    held whole on one device: the analog of the reference's ``SVDWide``
    over an in-RAM matrix (svdwide.h:11-31), behind ``pca()``,
    ``check()`` and ``ucca()`` on a numeric matrix and ``--batch``.

    Its products are ``torch.matmul`` in the operator's dtype, with TF32
    off (:func:`resolve_device`), as the JAX package's are ``jnp.dot``
    outside any Pallas kernel: no hand-written kernel runs on it, so it
    launches and counts none.  The sample "permutation" is the identity.

    Parameters
    ----------
    X_std : (N, p) numpy array or torch tensor.  A tensor already on
        the operator's device in its dtype is held as it is (a matrix
        built on the card never goes through the host); anything else,
        a numpy array above all, is copied, so that editing the
        caller's array later leaves the operator as it was.
    dtype : float32 (CUDA default) or float64 (CPU default).
    device : ``None`` -> ``cuda`` (raises without a GPU).
    center, scale : the per-SNP stats X was standardized with, reported
        as ``PCAResult.center/scale`` (default zeros and ones).
    """

    def __init__(self, X_std, *, dtype=None, device=None, center=None,
                 scale=None):
        self.device = resolve_device(device)
        self.dtype = as_torch_dtype(dtype) or default_dtype(self.device)
        X = (X_std if isinstance(X_std, torch.Tensor)
             else torch.tensor(np.asarray(X_std)))
        if X.ndim != 2:
            raise ValueError(f"X must be a 2-D matrix, got {X.ndim}-D")
        self.X = X.to(self.device, self.dtype).contiguous()
        self.n_samples, self.n_snps = (int(d) for d in self.X.shape)
        self.center = (np.zeros(self.n_snps) if center is None
                       else np.asarray(center, dtype=np.float64))
        self.scale = (np.ones(self.n_snps) if scale is None
                      else np.asarray(scale, dtype=np.float64))
        self._sumsq = None
        self.nops = 0

    _as_2d = _PackedBase._as_2d

    # -- permuted-space interface (identity) ---------------------------------
    @property
    def op_dim(self) -> int:
        return self.n_samples

    @property
    def supports_ff(self) -> bool:
        return True

    def permute(self, x):
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def permute_np(self, x):
        return np.asarray(x)

    def unpermute(self, yp):
        return yp

    def gram_permuted(self, xp):
        """X X^T xp; (N,) or (N, k) -> same."""
        vec = xp.ndim == 1
        x2 = xp[:, None] if vec else xp
        with span("op/gram", width(x2)):
            y = self.X @ (self.X.T @ x2.to(self.dtype))
        self.nops += 1
        return y[:, 0] if vec else y

    def gram_ff_permuted(self, xp):
        """(y_hi, y_lo) two-float pair of X X^T xp; the exact matrix here
        is X itself (:func:`dense_gram_ff`, which copies no part of
        X)."""
        from .compensated import dense_gram_ff

        vec = xp.ndim == 1
        x2 = (xp[:, None] if vec else xp).to(self.dtype)
        with span("op/gram_ff", width(x2)):
            hi, lo = dense_gram_ff(self.X, x2)
        self.nops += 1
        return (hi[:, 0], lo[:, 0]) if vec else (hi, lo)

    # -- products in (identity) permuted space, uncounted ---------------------
    def _cross_p(self, xp):
        with span("op/cross", width(xp)):
            return self.X.T @ xp

    def _mv_p(self, v):
        with span("op/prod", width(v)):
            return self.X @ v

    # -- public products -----------------------------------------------------
    def perform_op(self, x):
        """y = X X^T x; x is (N,) or (N, k)."""
        x2, vec = self._as_2d(x, self.n_samples, "perform_op")
        y = self.gram_permuted(x2)
        return y[:, 0] if vec else y

    def perform_op_ff(self, x):
        """Two-float twin of :meth:`perform_op`."""
        x2, vec = self._as_2d(x, self.n_samples, "perform_op_ff")
        hi, lo = self.gram_ff_permuted(x2)
        return (hi[:, 0], lo[:, 0]) if vec else (hi, lo)

    def crossprod(self, x):
        """z = X^T x; x is (N,) or (N, k) -> (p,) or (p, k)."""
        x2, vec = self._as_2d(x, self.n_samples, "crossprod")
        z = self._cross_p(x2)
        self.nops += 1
        return z[:, 0] if vec else z

    def prod(self, v):
        """y = X v; v is (p,) or (p, k) -> (N,) or (N, k)."""
        v2, vec = self._as_2d(v, self.n_snps, "prod")
        y = self._mv_p(v2)
        self.nops += 1
        return y[:, 0] if vec else y

    @property
    def snp_sumsq(self) -> np.ndarray:
        """Per-SNP sum of squares of X (float64 host), summed in row
        chunks in float64: X * X whole would be a second X."""
        if self._sumsq is None:
            rows = max(1, _SUMSQ_CHUNK_BYTES // (8 * self.n_snps))
            acc = torch.zeros(self.n_snps, dtype=torch.float64,
                              device=self.device)
            for r0 in range(0, self.n_samples, rows):
                blk = self.X[r0: r0 + rows].to(torch.float64)
                acc += (blk * blk).sum(dim=0)
            self._sumsq = acc.to("cpu").numpy()
        return self._sumsq

    @property
    def trace(self) -> float:
        """trace(X X^T) = sum of squares of X."""
        return float(self.snp_sumsq.sum())


# the fraction of the card's memory above which "auto" streams
STREAM_FRACTION = 0.7
STREAMING_OPERATORS = (StreamingPackedOperator, TallStreamingOperator)
# the operators of the wide gram X X^T, and of the tall gram X^T X
WIDE_OPERATORS = (PackedOperator, StreamingPackedOperator, DenseOperator)
TALL_OPERATORS = (TallPackedOperator, TallStreamingOperator)


def resolve_streaming(streaming, ds, device=None, mesh=None) -> bool:
    """Resolve the streaming tri-state ('auto'/True/False), for the wide
    and the tall gram alike: ``"auto"`` streams when the packed bytes
    exceed 0.7 x the card's total memory -- times the mesh's shard
    count, whose shards share the bytes -- and never on the CPU."""
    if streaming != "auto":
        return bool(streaming)
    dev = torch.device("cuda" if device is None else device)
    if mesh is not None:
        dev = mesh.devices[0]
    if dev.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(
        resolve_device(dev)).total_memory
    if mesh is not None:
        total *= mesh.size
    return ds.n_snps * ds.nbytes_per_snp > STREAM_FRACTION * total


def build_packed_operator(ds, mean, sd, *, tall: bool = False,
                          streaming="auto", memory_mb: int | None = None,
                          block_size: int | None = None, dtype=None,
                          device=None, mesh=None, snp_sumsq=None,
                          cache_mb="auto"):
    """The operator an analysis mode runs on: the wide gram X X^T, or
    with ``tall`` the tall gram X^T X; resident, or streamed from the
    host when ``streaming`` resolves to it (:func:`resolve_streaming`).
    With a ``mesh`` it is sharded, and each process reads only its own
    shards' bytes (parallel/dist.py's loaders; the streaming operators
    stage only theirs).  ``memory_mb`` bounds the streaming operators
    only, so the resident ones ignore it (as the JAX package's do);
    ``block_size`` is the wide streaming operator's ``block_snps``, and
    the tall one, which blocks the samples, refuses it (as the JAX
    package's ``pca()`` does).  ``cache_mb`` is the streaming operators'
    device block cache (:class:`_StagedBlocks`); the resident ones ignore
    it."""
    kw = dict(dtype=dtype, snp_sumsq=snp_sumsq, device=device, mesh=mesh)
    if resolve_streaming(streaming, ds, device, mesh):
        if not tall:
            return StreamingPackedOperator(
                ds, mean, sd, ds.n_samples, memory_mb=memory_mb,
                block_snps=block_size, cache_mb=cache_mb, **kw)
        if block_size is not None:
            raise ValueError(
                "block_size= (SNPs per block) does not apply to the tall "
                "streaming path, which blocks the sample(byte) axis; "
                "bound its staged buffers with memory_mb= instead")
        return TallStreamingOperator(
            ds, mean, sd, ds.n_samples, memory_mb=memory_mb,
            cache_mb=cache_mb, **kw)
    cls = TallPackedOperator if tall else PackedOperator
    if mesh is None:
        packed = ds.read_packed()
    else:
        from ..parallel.dist import (load_sample_sharded_packed,
                                     load_sharded_packed)

        plan = cls.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                               nshards=mesh.size)
        load = load_sample_sharded_packed if tall else load_sharded_packed
        packed = load(ds, mesh, p_pad=plan["p_pad"],
                      nbytes_pad=plan["nbytes_pad"])
    return cls(packed, mean, sd, ds.n_samples, block_size=block_size,
               n_snps=ds.n_snps, **kw)


def check_operator_conflicts(op, *, dtype=None, streaming="auto",
                             memory_mb=None, block_size=None, device=None,
                             mesh=None):
    """Reject keyword requests that a PREBUILT operator cannot honor
    (its dtype, device, sharding and block geometry are fixed at
    construction)."""
    if memory_mb is not None:
        raise ValueError(
            "memory_mb= was passed with a prebuilt operator, whose "
            "residency and block geometry are fixed at construction; "
            "rebuild the operator with the desired memory_mb")
    if block_size is not None:
        raise ValueError(
            "block_size= was passed with a prebuilt operator, whose "
            "block geometry is fixed at construction; rebuild the "
            "operator with the desired blocking")
    dtype = as_torch_dtype(dtype)
    if dtype is not None and dtype != op.dtype:
        raise ValueError(
            f"dtype={dtype} conflicts with the prebuilt operator's "
            f"dtype={op.dtype}; rebuild the operator with the desired dtype")
    if device is not None and torch.device(device).type != op.device.type:
        raise ValueError(
            f"device={device} conflicts with the prebuilt operator's "
            f"device={op.device}; rebuild the operator on that device")
    # value equality: an identical mesh built again is the same mesh
    if mesh is not None and getattr(op, "mesh", None) != mesh:
        raise ValueError(
            "mesh= conflicts with the prebuilt operator's device "
            "placement; build the operator on the target mesh instead")
    is_stream = isinstance(op, STREAMING_OPERATORS)
    if streaming is True and not is_stream:
        raise ValueError(
            "streaming=True was passed with a device-resident prebuilt "
            "operator; build a StreamingPackedOperator / "
            "TallStreamingOperator (or pass the PLINK data) for bounded "
            "device memory")
    if streaming is False and is_stream:
        raise ValueError(
            "streaming=False was passed with a prebuilt streaming "
            "operator; build a resident operator instead")
