"""Multi-device and multi-process distribution of the packed genotypes.

The scaling story is 1-D sharding of the packed bytes: the wide gram
shards SNP rows (SNP j of a PLINK .bed lives at byte offset
``3 + j * ceil(N/4)``, so a contiguous SNP range is a contiguous byte
range and every process reads only its own rows of the file), the tall
gram shards byte columns, that is samples.  Each shard's partial
products are summed on its process and across processes by the
operators themselves (ops/operator.py).

A :class:`Mesh` holds this process's shard devices in shard order and
the ``torch.distributed`` process group (None in one process).  A
device may appear more than once: two shards on ``cuda:0``, or eight
on ``"cpu"``, split the work exactly as two cards or eight hosts would.

Collectives are ``all_reduce(SUM)`` and ``broadcast`` only: gloo
supports just these two on CUDA tensors, so one code path serves gloo
on the CPU, gloo on one card and NCCL across cards.  A gather is an
all-reduce of zero-filled disjoint slices, which is bit-exact in any
float type (x + 0 == x).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.plink import PACK_DENSITY, PlinkDataset


# ---------------------------------------------------------------------------
# The runtime and the mesh
# ---------------------------------------------------------------------------

def init_distributed(**kwargs) -> None:
    """Initialize the ``torch.distributed`` default process group
    (idempotent: a second call does nothing).

    ``kwargs`` go to ``torch.distributed.init_process_group``: give it
    ``init_method="tcp://localhost:<port>"`` (or ``env://`` with
    MASTER_ADDR/MASTER_PORT set), ``world_size`` and ``rank``.  The
    backend is the caller's choice: ``"nccl"`` across cards, ``"gloo"``
    on the CPU -- and on one card shared by several processes, which
    NCCL refuses (it needs one GPU per rank)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(**kwargs)


class Mesh:
    """A 1-D mesh of shards: this process's shard devices in shard order
    and the process group whose processes contribute theirs, rank by
    rank.

    ``size`` is the global shard count, ``shape`` maps each axis name to
    its length (as a JAX mesh's), ``offset`` is the global index of this
    process's first shard.  Equal meshes hold the same devices, axis
    names and group."""

    def __init__(self, devices, axis_names=("snps",), group=None):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self._grid = devs
        self.devices = tuple(torch.device(d) for d in devs.reshape(-1))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        counts = [len(self.devices)]
        self.rank, self.nproc = 0, 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.nproc = dist.get_world_size(group)
            mine = torch.zeros(self.nproc, dtype=torch.int64)
            mine[self.rank] = len(self.devices)
            counts = self.all_sum(mine).tolist()
        self.counts = counts
        self.offset = int(sum(counts[: self.rank]))
        self.size = int(sum(counts))

    @property
    def shape(self) -> dict:
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: self.size}
        return dict(zip(self.axis_names, self._grid.shape))

    @property
    def local_shards(self):
        """(global shard index, device) of this process's shards."""
        return [(self.offset + i, d) for i, d in enumerate(self.devices)]

    @property
    def multiprocess(self) -> bool:
        return self.nproc > 1

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.rank == 0

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names
                and self.group is other.group)

    def __hash__(self):
        return hash((self.devices, self.axis_names, id(self.group)))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names}, size={self.size}, "
                f"process {self.rank} of {self.nproc})")

    # -- collectives ---------------------------------------------------------
    def _comm_device(self):
        """Where host values travel: the CPU under gloo, this process's
        first card under NCCL."""
        import torch.distributed as dist

        if dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` -- each process's partial -- summed over the group's
        processes (a new tensor on ``t``'s device; ``t`` itself in one
        process)."""
        if self.group is None or self.nproc == 1:
            return t
        import torch.distributed as dist

        home = t.device
        buf = t.to(self._comm_device()).contiguous().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(home)

    def gather_rows(self, parts, total: int, like: torch.Tensor,
                    device) -> torch.Tensor:
        """Rows [lo, hi) of a (total, ...) result from each process's
        ``parts`` ((lo, hi, rows) with rows on any device), assembled on
        ``device``: the parts in order in one process, zero-filled
        disjoint slices summed across processes otherwise."""
        if not self.multiprocess:
            if not parts:
                return like.new_zeros((total, *like.shape[1:]))
            return torch.cat([r.to(device) for _, _, r in parts])
        out = torch.zeros((total, *like.shape[1:]), dtype=like.dtype,
                          device=device)
        for lo, hi, r in parts:
            out[lo:hi] = r.to(device)
        return self.all_sum(out)

    def fold_pairs(self, hi: torch.Tensor, lo: torch.Tensor):
        """Two-float pairs (hi, lo) of each process folded in process
        order with TwoSum (the fold of the shards within a process),
        the same bits on every process: a plain sum of the hi halves
        would round away the pairs' extra precision."""
        if not self.multiprocess:
            return hi, lo
        from ..ops.compensated import twosum

        stack = torch.zeros((self.nproc, 2, *hi.shape), dtype=hi.dtype,
                            device=hi.device)
        stack[self.rank, 0] = hi
        stack[self.rank, 1] = lo
        stack = self.all_sum(stack)
        y_hi, y_lo = stack[0, 0], stack[0, 1]
        for r in range(1, self.nproc):
            y_hi, e = twosum(y_hi, stack[r, 0])
            y_lo = y_lo + e + stack[r, 1]
        return y_hi, y_lo

    def agree(self, *arrays):
        """Host arrays as rank 0 holds them, on every process (one
        broadcast): the values a control decision is taken from, so that
        no process takes another branch.  Returns the arrays unchanged
        in one process."""
        if not self.multiprocess:
            return arrays if len(arrays) != 1 else arrays[0]
        import torch.distributed as dist

        flat = [np.asarray(a) for a in arrays]
        buf = torch.as_tensor(np.concatenate(
            [a.astype(np.float64).reshape(-1) for a in flat]),
            device=self._comm_device())
        dist.broadcast(buf, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        vals = buf.cpu().numpy()
        out, at = [], 0
        for a in flat:
            out.append(vals[at: at + a.size].reshape(a.shape).astype(
                a.dtype))
            at += a.size
        return tuple(out) if len(out) != 1 else out[0]

    def barrier(self) -> None:
        """Wait for every process (an all-reduce of one number)."""
        if self.multiprocess:
            self.all_sum(torch.zeros(1))


def snp_mesh(devices=None, axis_name: str = "snps", group=None) -> Mesh:
    """1-D mesh for SNP (or, on the tall path, sample) sharding.

    ``group``: the process group (default: the world group when
    ``torch.distributed`` is initialized with more than one process,
    else none).  ``devices``: this process's shard devices (default:
    one per process, ``cuda:LOCAL_RANK``, under a group; every visible
    card in one process).  Repeating a device puts several shards on
    it."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        group = dist.group.WORLD
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] "
                "for CPU shards")
        if group is not None:
            devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"]
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,), group)


def _require_1d(mesh: Mesh, fn: str) -> None:
    """The loaders pair the mesh's devices with 1-D range plans; a
    multi-axis mesh would mispair them."""
    if len(mesh.shape) != 1:
        raise ValueError(
            f"{fn} needs a 1-D mesh (got axes {tuple(mesh.shape)}); "
            "build it with parallel.snp_mesh()")


def agree_fn(op):
    """The operator's mesh's :meth:`Mesh.agree` when it spans processes,
    else None (nothing to agree on)."""
    mesh = getattr(op, "mesh", None)
    return mesh.agree if mesh is not None and mesh.multiprocess else None


def writer(op) -> bool:
    """Whether this process writes an operator's run's files."""
    mesh = getattr(op, "mesh", None)
    return mesh is None or mesh.is_writer


def barrier(op) -> None:
    mesh = getattr(op, "mesh", None)
    if mesh is not None:
        mesh.barrier()


# ---------------------------------------------------------------------------
# Planning and per-process loading: SNP rows (the wide gram)
# ---------------------------------------------------------------------------

def plan_row_shards(p_pad: int, n_shards: int) -> list[tuple[int, int]]:
    """Equal [start, stop) row ranges of the padded SNP dimension."""
    if p_pad % n_shards:
        raise ValueError(f"{p_pad} rows do not split into {n_shards} "
                         "equal shards")
    step = p_pad // n_shards
    return [(i * step, (i + 1) * step) for i in range(n_shards)]


def shard_byte_ranges(ds: PlinkDataset, p_pad: int,
                      n_shards: int) -> list[tuple[int, int]]:
    """File byte ranges [lo, hi) each shard must read (clipped to the
    real SNP count; padding rows are zeros and read nothing)."""
    out = []
    for start, stop in plan_row_shards(p_pad, n_shards):
        start = min(start, ds.n_snps)
        stop = min(stop, ds.n_snps)
        out.append(ds.byte_range(start, stop))
    return out


def load_sharded_packed(ds: PlinkDataset, mesh: Mesh, *, p_pad: int,
                        nbytes_pad: int, axis_name: str = "snps"):
    """This process's (p_pad / size, nbytes_pad) uint8 shards of the SNP
    rows, each on its device and read from its own byte range of the
    .bed only; padding rows and bytes are zeros."""
    _require_1d(mesh, "load_sharded_packed")
    rows = plan_row_shards(p_pad, mesh.size)
    out = []
    for i, dev in mesh.local_shards:
        start, stop = rows[i]
        lo, hi = min(start, ds.n_snps), min(stop, ds.n_snps)
        buf = np.zeros((stop - start, nbytes_pad), dtype=np.uint8)
        if hi > lo:
            buf[: hi - lo, : ds.nbytes_per_snp] = ds.read_packed(lo, hi)
        out.append(torch.from_numpy(buf).to(dev))
    return out


def sharded_snp_stats(ds: PlinkDataset, mesh: Mesh, p_pad: int, *,
                      stand: str = "binom2", axis_name: str = "snps",
                      with_sumsq: bool = False):
    """Per-SNP (mean, sd) -- and with ``with_sumsq`` the exact per-SNP
    sum of squared standardized genotypes -- with each process reading
    only its own shards' rows, summed across processes in float64.  In
    one process this is ``ds.snp_stats(stand)``."""
    if not mesh.multiprocess:
        return ds.snp_stats(stand, with_sumsq=with_sumsq)
    _require_1d(mesh, "sharded_snp_stats")
    rows = plan_row_shards(p_pad, mesh.size)
    local = np.zeros((3 if with_sumsq else 2, ds.n_snps))
    for i, _ in mesh.local_shards:
        lo, hi = (min(r, ds.n_snps) for r in rows[i])
        if hi > lo:
            # per-SNP values: each range's are independent of the others
            local[:, lo:hi] = ds.snp_stats(stand, snp_range=(lo, hi),
                                           with_sumsq=with_sumsq)
    # disjoint ranges, zeros elsewhere: the float64 sum is exact
    return tuple(mesh.all_sum(torch.from_numpy(local)).numpy())


def _plan(cls, ds, mesh, block_size, dtype):
    return cls.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                           block_size=block_size, dtype=dtype,
                           nshards=mesh.size)


def sharded_operator(data, mesh: Mesh | None = None, *,
                     stand: str = "binom2", block_size: int | None = None,
                     dtype=None, axis_name: str = "snps",
                     use_kernels: bool | None = None):
    """A SNP-sharded :class:`PackedOperator` of a PLINK fileset (a
    ``--bfile`` root or an opened :class:`PlinkDataset`), each process
    reading only its own shards' rows."""
    from ..ops.operator import PackedOperator
    from ..utils.device import as_torch_dtype, default_dtype

    mesh = snp_mesh(axis_name=axis_name) if mesh is None else mesh
    _require_1d(mesh, "sharded_operator")
    ds = PlinkDataset.open(data) if isinstance(data, str) else data
    dtype = as_torch_dtype(dtype) or default_dtype(mesh.devices[0])
    plan = _plan(PackedOperator, ds, mesh, block_size, dtype)
    mean, sd, sumsq = sharded_snp_stats(ds, mesh, plan["p_pad"],
                                        stand=stand, with_sumsq=True)
    shards = load_sharded_packed(ds, mesh, p_pad=plan["p_pad"],
                                 nbytes_pad=plan["nbytes_pad"])
    return PackedOperator(shards, mean, sd, ds.n_samples, mesh=mesh,
                          block_size=plan["block_size"], dtype=dtype,
                          n_snps=ds.n_snps, snp_sumsq=sumsq,
                          use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# Byte columns (samples: the tall gram)
# ---------------------------------------------------------------------------

def plan_byte_shards(nbytes_pad: int, n_shards: int) -> list[tuple[int, int]]:
    """Equal [lo, hi) byte-column ranges of the padded sample axis."""
    if nbytes_pad % n_shards:
        raise ValueError(f"{nbytes_pad} bytes do not split into "
                         f"{n_shards} equal shards")
    step = nbytes_pad // n_shards
    return [(i * step, (i + 1) * step) for i in range(n_shards)]


def load_sample_sharded_packed(ds: PlinkDataset, mesh: Mesh, *, p_pad: int,
                               nbytes_pad: int, axis_name: str = "samples"):
    """This process's (p_pad, nbytes_pad / size) uint8 shards of the
    byte columns, each on its device and read as a byte-column window
    of every SNP row of the .bed (strided reads through the memmap);
    padding rows and bytes are zeros."""
    _require_1d(mesh, "load_sample_sharded_packed")
    cols = plan_byte_shards(nbytes_pad, mesh.size)
    nb = ds.nbytes_per_snp
    out = []
    for i, dev in mesh.local_shards:
        lo, hi = cols[i]
        lo_r, hi_r = min(lo, nb), min(hi, nb)
        buf = np.zeros((p_pad, hi - lo), dtype=np.uint8)
        if hi_r > lo_r:
            buf[: ds.n_snps, : hi_r - lo_r] = ds._map()[:, lo_r:hi_r]
        out.append(torch.from_numpy(buf).to(dev))
    return out


def sample_sharded_moments(ds: PlinkDataset, mesh: Mesh, *, nbytes_pad: int,
                           axis_name: str = "samples"):
    """Per-SNP raw dosage moments (ngood, dsum, d2sum), each process
    decoding only its own shards' sample windows: partial moments of
    disjoint sample ranges add exactly, and the float64 vectors are
    summed across processes.  In one process this is
    ``ds.snp_moments()``."""
    from ..io.plink import snp_moments_from_packed

    if not mesh.multiprocess:
        return ds.snp_moments()
    _require_1d(mesh, "sample_sharded_moments")
    cols = plan_byte_shards(nbytes_pad, mesh.size)
    nb = ds.nbytes_per_snp
    local = np.zeros((3, ds.n_snps))
    blk = 8192       # SNP blocks bound the decode intermediates
    for i, _ in mesh.local_shards:
        lo, hi = (min(c, nb) for c in cols[i])
        if hi <= lo:
            continue
        # a byte window is itself a packed block of ns samples
        ns = min(ds.n_samples - lo * PACK_DENSITY, (hi - lo) * PACK_DENSITY)
        for start in range(0, ds.n_snps, blk):
            stop = min(start + blk, ds.n_snps)
            sub = np.ascontiguousarray(ds._map()[start:stop, lo:hi])
            local[:, start:stop] += snp_moments_from_packed(sub, ns)
    return tuple(mesh.all_sum(torch.from_numpy(local)).numpy())


def tall_sharded_operator(data, mesh: Mesh | None = None, *,
                          stand: str = "binom2",
                          block_size: int | None = None, dtype=None,
                          axis_name: str = "samples",
                          use_kernels: bool | None = None):
    """A sample(byte)-sharded :class:`TallPackedOperator` of a PLINK
    fileset, each process reading only its own byte-column windows: the
    tall twin of :func:`sharded_operator`."""
    from ..io.plink import stats_from_moments
    from ..ops.operator import TallPackedOperator
    from ..ops.standardize import sumsq_from_moments
    from ..utils.device import as_torch_dtype, default_dtype

    if stand not in ("binom", "binom2"):
        # fail before the per-process decode and the reduction
        raise ValueError(f"unknown standardisation method: {stand}")
    mesh = snp_mesh(axis_name=axis_name) if mesh is None else mesh
    _require_1d(mesh, "tall_sharded_operator")
    ds = PlinkDataset.open(data) if isinstance(data, str) else data
    dtype = as_torch_dtype(dtype) or default_dtype(mesh.devices[0])
    plan = _plan(TallPackedOperator, ds, mesh, block_size, dtype)
    ngood, dsum, d2sum = sample_sharded_moments(
        ds, mesh, nbytes_pad=plan["nbytes_pad"])
    mean, sd = stats_from_moments(ngood, dsum, stand)
    sumsq = sumsq_from_moments(ngood, dsum, d2sum, mean, sd)
    shards = load_sample_sharded_packed(ds, mesh, p_pad=plan["p_pad"],
                                        nbytes_pad=plan["nbytes_pad"])
    return TallPackedOperator(shards, mean, sd, ds.n_samples, mesh=mesh,
                              block_size=plan["block_size"], dtype=dtype,
                              n_snps=ds.n_snps, snp_sumsq=sumsq,
                              use_kernels=use_kernels)
