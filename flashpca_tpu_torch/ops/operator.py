"""Matrix-free genotype operator on one device.

The counterpart of the reference's ``SVDWide`` (svdwide.h:11-107):
products against the implicitly standardized genotype matrix X
(N samples x p SNPs), where X never materializes -- the packed 2-bit
bytes decode to standardized floats on the fly.

Products (reference naming in parens):

* ``perform_op(x)``  : y = X X^T x        (perform_op / perform_op_mat)
* ``crossprod(x)``   : z = X^T x          (crossprod / crossprod2)
* ``prod(v)``        : y = X v            (prod / prod3)
* ``perform_op_ff``  : the same gram as a two-float (hi, lo) pair
* ``snp_sumsq`` / ``trace`` : per-SNP sums of squares and their total

Two paths compute the same products:

* on CUDA (float32) the hand-written kernels B1-B4
  (kernels/packed_matvec.py);
* on the CPU the blocked PyTorch functional core below (decode a block
  of SNP rows, then matmul) in float32 or float64 -- or, with
  ``use_kernels=True``, the kernels' plain versions.

No padding of either axis is needed: the kernels mask their own ragged
edges and the core slices its last block.  Byte-padding SAMPLE
positions (the garbage codes past n in the last byte) are masked on
input and output of every gram product, which keeps it symmetric.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.plink import PACK_DENSITY, bytes_per_snp
from ..utils.device import as_torch_dtype, default_dtype, resolve_device
from .genotypes import (
    decode_standardized,
    permute_samples,
    permute_samples_np,
    unpermute_samples,
    valid_mask_permuted,
)
from .standardize import lookup_tables


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
# The operator
# ---------------------------------------------------------------------------

class PackedOperator:
    """Device-resident packed-genotype operator (one device, no mesh).

    Parameters
    ----------
    packed : (p, nbytes) uint8, the raw .bed payload (numpy or a torch
        tensor, e.g. generated on the card).
    mean, sd : per-SNP standardization stats (float64, exact).
    n_samples : true N.
    device : ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` runs
        the PyTorch path.
    dtype : float32 (CUDA default, the kernels' type) or float64 (CPU
        default).  float64 on CUDA is not ported yet.
    block_size : SNPs decoded per block on the CPU path (the analog of
        the reference's --blocksize).
    use_kernels : run the products through kernels/packed_matvec.py:
        always on CUDA; on the CPU ``True`` selects the kernels' plain
        versions (float32) instead of the functional core.
    """

    def __init__(self, packed, mean, sd, n_samples: int, *, device=None,
                 dtype=None, block_size: int | None = None,
                 use_kernels: bool | None = None, n_snps: int | None = None,
                 snp_sumsq=None):
        self.device = resolve_device(device)
        dtype = as_torch_dtype(dtype) or default_dtype(self.device)
        nbytes = bytes_per_snp(n_samples)
        p = int(n_snps) if n_snps is not None else int(packed.shape[0])
        if tuple(packed.shape) != (p, nbytes):
            raise ValueError(f"packed shape {tuple(packed.shape)} is not "
                             f"the raw ({p}, {nbytes}) layout")
        if self.device.type == "cuda":
            if dtype != torch.float32:
                raise NotImplementedError(
                    "float64 on CUDA is not ported yet (ROADMAP B: the "
                    "kernels are float32); use device='cpu' for float64")
            if use_kernels is False:
                raise ValueError("the CUDA operator always runs the kernels")
            use_kernels = True
        elif use_kernels and dtype != torch.float32:
            raise ValueError("use_kernels=True runs the float32 kernels' "
                             "plain versions; pass dtype=float32")
        self.use_kernels = bool(use_kernels)
        self.n_samples = int(n_samples)
        self.n_snps = p
        self.nbytes = int(nbytes)
        self.n4 = self.nbytes * PACK_DENSITY
        self.dtype = dtype
        # exact f64 standardization stats (reported as center/scale)
        self.center = np.asarray(mean, dtype=np.float64)
        self.scale = np.asarray(sd, dtype=np.float64)
        self.block_size = self.plan_layout(p, nbytes, block_size=block_size,
                                           dtype=dtype)["block_size"]

        if isinstance(packed, torch.Tensor):
            self.packed = packed.to(self.device, torch.uint8).contiguous()
        else:
            # np.require copies read-only (memory-mapped) input once
            self.packed = torch.from_numpy(
                np.require(packed, np.uint8, ["C", "W"])).to(self.device)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        mean_f, invsd_f = lookup_tables(mean, sd, dtype=np_dtype)
        self.mean = torch.as_tensor(mean_f, device=self.device)
        self.invsd = torch.as_tensor(invsd_f, device=self.device)
        self._valid = valid_mask_permuted(n_samples, self.nbytes, dtype,
                                          self.device)
        self._sumsq = _host_sumsq(snp_sumsq, p)
        self._trace = None
        self._luts = None
        self.nops = 0

    @staticmethod
    def plan_layout(p, nbytes, *, block_size=None, dtype=torch.float64):
        """Layout of (p, nbytes) packed data.  The kernels mask their own
        ragged edges, so nothing is padded (``p_pad == p``,
        ``nbytes_pad == nbytes``); ``block_size`` is the CPU core's SNPs
        per decoded block (~128 MiB of decoded floats)."""
        if block_size is None:
            itemsize = torch.finfo(dtype).bits // 8
            block_size = max(128, (128 << 20)
                             // (nbytes * PACK_DENSITY * itemsize))
        return dict(p_pad=int(p), nbytes_pad=int(nbytes),
                    block_size=int(max(1, min(block_size, p))))

    # -- permuted-space interface (used by the eigensolver) ------------------
    @property
    def op_dim(self) -> int:
        """Length of permuted-space vectors."""
        return self.n4

    def permute(self, x):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        return permute_samples(x, self.nbytes)

    def permute_np(self, x):
        """Host numpy twin of :meth:`permute`."""
        return permute_samples_np(x, self.nbytes)

    def unpermute(self, yp):
        return unpermute_samples(yp, self.n_samples)

    def _as_2d(self, x, length, name):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        vec = x.ndim == 1
        if vec:
            x = x[:, None]
        if x.shape[0] != length:
            raise ValueError(
                f"{name}: expected leading dim {length}, got {x.shape[0]}")
        return x, vec

    # -- raw products (permuted space, masked) -------------------------------
    def _gram_p(self, xp):
        v = self._valid[:, None]
        xp = xp * v
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            y = kpm.gram_matvec_p(self.packed, self.mean, self.invsd, xp)
        else:
            y = gram_matvec_p(self.packed, self.mean, self.invsd, xp,
                              block_size=self.block_size)
        return y.to(self.dtype) * v

    def _cross_p(self, xp):
        xp = xp * self._valid[:, None]
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            return kpm.crossprod_p(self.packed, self.mean, self.invsd,
                                   xp).to(self.dtype)
        return crossprod_p(self.packed, self.mean, self.invsd, xp,
                           block_size=self.block_size)

    def _mv_p(self, v2):
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            y = kpm.matvec_p(self.packed, self.mean, self.invsd, v2)
        else:
            y = matvec_p(self.packed, self.mean, self.invsd, v2,
                         block_size=self.block_size)
        return y.to(self.dtype) * self._valid[:, None]

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

    # -- trace -----------------------------------------------------------------
    @property
    def snp_sumsq(self) -> np.ndarray:
        """Per-SNP sum of squared standardized genotypes (float64 host)."""
        if self._sumsq is None:
            bs = budget_block_size(self.n_snps, self.n4)
            sq = snp_sumsq_p(self.packed, self.mean, self.invsd, self._valid,
                             block_size=bs)
            self._sumsq = sq.to("cpu", torch.float64).numpy()
        return self._sumsq

    @property
    def trace(self) -> float:
        """trace(X X^T) = sum of squares of X (svdwide.cpp:44-45)."""
        return float(self.snp_sumsq.sum())

    # -- compensated (two-float) product -------------------------------------
    def _ff_luts(self):
        """Exact two-float code tables (p, 4), built on first use."""
        if self._luts is None:
            from .compensated import code_value_luts

            lh, ll = code_value_luts(self.center, self.scale)
            self._luts = (torch.as_tensor(lh, device=self.device),
                          torch.as_tensor(ll, device=self.device))
        return self._luts

    def gram_ff_permuted(self, xp):
        """(y_hi, y_lo) two-float pair of X X^T xp, permuted space: the
        float64-grade product behind the contract polish and check()."""
        lut_hi, lut_lo = self._ff_luts()
        vec = xp.ndim == 1
        xp2 = (xp[:, None] if vec else xp).to(self.dtype)
        v = self._valid[:, None]
        if self.use_kernels:
            from ..kernels import packed_matvec as kpm

            hi, lo = kpm.gram_ff_p(self.packed, lut_hi, lut_lo, xp2 * v)
        else:
            from .compensated import default_chunk, gram_ff_p

            bs = budget_block_size(self.n_snps, self.n4, itemsize=8,
                                   cap=default_chunk())
            hi, lo = gram_ff_p(self.packed, lut_hi, lut_lo, xp2 * v,
                               block_size=bs)
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

    def stats(self) -> dict:
        """Observability counters: operator products dispatched, packed
        bytes resident, per-pass decode volume, and the kernel launches
        so far (process-wide counts of kernels/packed_matvec.py)."""
        from ..kernels.packed_matvec import launch_counts

        nbytes = self.n_snps * self.nbytes
        itemsize = torch.finfo(self.dtype).bits // 8
        return {
            "nops": self.nops,
            "packed_bytes": nbytes,
            "decoded_gb_per_pass": nbytes * 4 * itemsize / 1e9,
            "use_kernels": self.use_kernels,
            "device": str(self.device),
            "block_size": self.block_size,
            "kernel_launches": dict(launch_counts),
        }


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


def build_packed_operator(ds, mean, sd, *, streaming="auto",
                          memory_mb: int | None = None,
                          block_size: int | None = None, dtype=None,
                          device=None, mesh=None, snp_sumsq=None):
    """The operator an analysis mode runs on.  Only the device-resident,
    single-device operator is ported: ``streaming=True`` raises (ROADMAP
    A15) and so does a ``mesh`` (ROADMAP A18).  ``memory_mb`` bounds the
    streaming operator only, so the resident operator ignores it (as the
    JAX package's resident operator does)."""
    if streaming is True:
        raise NotImplementedError(
            "streaming=True: the streaming operator is not ported yet "
            "(ROADMAP A15 'Streaming')")
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: multi-GPU sharding is not ported yet (ROADMAP A18 "
            "'Multi-GPU')")
    return PackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                          block_size=block_size, dtype=dtype, device=device,
                          snp_sumsq=snp_sumsq)


def check_operator_conflicts(op, *, dtype=None, streaming="auto",
                             memory_mb=None, block_size=None, device=None):
    """Reject keyword requests that a PREBUILT operator cannot honor
    (its dtype, device and block geometry are fixed at construction)."""
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
    if streaming is True:
        raise ValueError(
            "streaming=True was passed with a device-resident prebuilt "
            "operator")
