"""The port across processes: two ``torch.distributed`` processes on
gloo, each with two CPU shards (a 4-shard mesh), against the port in one
process and the JAX package's one-process result on the same fileset --
the counterpart of tests/test_multiprocess.py.

The two workers run once for the whole module (this file, run as a
script, is the worker) and go through every mode in turn, each writing
its results; the tests then read them.  Every mode must give both
processes the same bits (the lockstep the broadcast control decisions
keep) and agree with the one-process runs.

Tolerances, with their reasons (tests/test_multiprocess.py's bars):

* float64 products: rtol 1e-9 against the dense oracle and against the
  one-process operator (shard sums in another order).
* the float64 stats: bit-equal (disjoint ranges summed with zeros).
* ``pca`` at float64: eigenvalues rtol 1e-9, vector RMSE < 1e-8; at
  float32 (the kernels' plain versions): eigenvalues rtol 2e-5, RMSE
  < 1e-4.
* ``scca``: d rtol 1e-9, U and V atol 1e-8 against the one-process
  port (the same iteration on the same products); JAX's bars
  (tests/test_multiprocess.py) against the JAX package.
* ``ucca``: rtol 1e-9; ``check``: mse < 1e-12 and err rtol 1e-6.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

NPROC = 2
SHARDS = ("cpu", "cpu")          # each process's shard devices
WORKER_TIMEOUT_S = 240
MODES = ("shard", "stats", "pca", "pca32", "scca", "ucca", "check",
         "tall", "tall32", "tallstream")


# ---------------------------------------------------------------------------
# The worker (this file run as a script): every mode in turn
# ---------------------------------------------------------------------------

def _worker(small, root, rank, nproc, port, outdir):
    import torch

    torch.set_num_threads(1)
    import flashpca_tpu_torch as ft
    from flashpca_tpu_torch.parallel import (
        init_distributed, sample_sharded_moments, sharded_operator,
        snp_mesh, tall_sharded_operator)
    from flashpca_tpu_torch.parallel.dist import sharded_snp_stats

    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                     world_size=nproc, rank=rank)
    mesh = snp_mesh(list(SHARDS))
    assert mesh.size == len(SHARDS) * nproc and mesh.multiprocess
    tmesh = snp_mesh(list(SHARDS), axis_name="samples")

    def save(mode, **arrays):
        np.savez(os.path.join(outdir, f"{mode}{rank}.npz"), **arrays)

    rng = np.random.default_rng(0)            # the same on every process
    ds = ft.PlinkDataset.open(small)
    x = rng.standard_normal((ds.n_samples, 2))
    v = rng.standard_normal((ds.n_snps, 2))
    op = sharded_operator(ds, mesh, dtype=torch.float64)
    save("shard", y=op.perform_op(x).numpy(), w=op.prod(v).numpy(),
         z=op.crossprod(x).numpy(), trace=op.trace,
         ff=sum(op.perform_op_ff(x)).numpy())

    plan = ft.PackedOperator.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                                         nshards=mesh.size)
    mean, sd = sharded_snp_stats(ds, mesh, plan["p_pad"])
    tplan = ft.TallPackedOperator.plan_layout(ds.n_snps, ds.nbytes_per_snp,
                                              nshards=mesh.size)
    moments = sample_sharded_moments(ds, tmesh,
                                     nbytes_pad=tplan["nbytes_pad"])
    save("stats", mean=mean, sd=sd, moments=np.stack(moments))

    for mode, dt in (("pca", torch.float64), ("pca32", torch.float32)):
        kw = {"use_kernels": True} if dt == torch.float32 else {}
        op = sharded_operator(root, mesh, dtype=dt, **kw)
        state = os.path.join(outdir, f"{mode}_state.npz")
        first_converged = True
        try:
            # a starved solve writes its state, then raises
            ft.pca(op, 5, tol=1e-10, maxiter=1, state_out=state)
        except RuntimeError:
            first_converged = False
        res = ft.pca(op, 5, tol=1e-7, state_in=state, state_out=state,
                     do_loadings=True)
        save(mode, values=res.values, vectors=res.vectors,
             loadings=res.loadings, pve=res.pve, trace=res.trace,
             projection=res.projection, n_ops=res.n_ops,
             first_converged=first_converged)

    op = sharded_operator(root, mesh, dtype=torch.float64)
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((op.n_samples, 3))
    V0 = rng.standard_normal((3, 2))
    res = ft.scca(op, Y, 1e-3, 1e-3, ndim=2, V0=V0, tol=1e-7, maxiter=500)
    save("scca", U=res.U, V=res.V, d=res.d, Px=res.Px, Py=res.Py,
         converged=res.converged)
    save("ucca", result=ft.ucca(op, Y).result)
    res = ft.pca(op, 4, tol=1e-9)
    chk = ft.check(op, res.vectors, res.values)
    save("check", err=chk.err, mse=chk.mse, rmse=chk.rmse,
         values=res.values)

    ds = ft.PlinkDataset.open(root)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((ds.n_snps, 2))
    for mode, dt in (("tall", torch.float64), ("tall32", torch.float32)):
        kw = {"use_kernels": True} if dt == torch.float32 else {}
        top = tall_sharded_operator(ds, tmesh, dtype=dt, **kw)
        u = top.gram_permuted(torch.as_tensor(v, dtype=dt)).numpy()
        res = ft.pca(top, 4, tol=1e-6 if mode == "tall32" else 1e-9)
        save(mode, gram=u, values=res.values, vectors=res.vectors,
             pve=res.pve, trace=res.trace, n_ops=res.n_ops)
    mean, sd = ds.snp_stats("binom2")
    top = ft.TallStreamingOperator(ds, mean, sd, ds.n_samples, block_bytes=16,
                                   dtype=torch.float64, mesh=tmesh,
                                   cache_mb=0)
    assert top.n_blocks > 2               # really several staged items
    u = top.gram_permuted(torch.as_tensor(v)).numpy()
    res = ft.pca(top, 4, tol=1e-9)
    save("tallstream", gram=u, values=res.values, vectors=res.vectors,
         pve=res.pve, trace=res.trace, n_ops=res.n_ops)
    mesh.barrier()
    print(f"worker {rank} ok", flush=True)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_pca_plink(tmp_path_factory):
    """tests/test_multiprocess.py's fileset: big enough for the block
    solver (n = 300)."""
    from flashpca_tpu.io.plink import write_bed

    rng = np.random.default_rng(7)
    n, p = 300, 120
    maf = rng.uniform(0.05, 0.5, size=p)
    geno = rng.binomial(2, maf[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=(n, p)) < 0.03] = np.nan
    root = str(tmp_path_factory.mktemp("mp_pca") / "toy300")
    write_bed(root, geno)
    return root, geno


@pytest.fixture(scope="module")
def runs(small_plink, mp_pca_plink, tmp_path_factory):
    """Both workers' results, mode -> (rank 0's, rank 1's)."""
    out = str(tmp_path_factory.mktemp("mp_torch"))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), small_plink[0],
         mp_pca_plink[0], str(r), str(NPROC), port, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(NPROC)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {r} failed:\n{log}"
    return {m: tuple(np.load(os.path.join(out, f"{m}{r}.npz"))
                     for r in range(NPROC)) for m in MODES}


def _lockstep(d0, d1, keys):
    for key in keys:
        np.testing.assert_array_equal(d0[key], d1[key], err_msg=key)


def _dense(root):
    from flashpca_tpu.io.plink import PlinkDataset
    from flashpca_tpu.ops import dense_standardized_np

    ds = PlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    return ds, dense_standardized_np(ds.read_codes(), mean, sd).T


def _aligned_rmse(U, V):
    sign = np.sign(np.sum(U * V, axis=0))
    return float(np.sqrt(np.mean((U * sign[None, :] - V) ** 2)))


def test_two_process_shard_invariance(small_plink, runs):
    import flashpca_tpu_torch as ft
    from flashpca_tpu.ops.operator import PackedOperator as JPacked

    d0, d1 = runs["shard"]
    _lockstep(d0, d1, ("y", "w", "z", "trace", "ff"))
    ds, X = _dense(small_plink[0])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ds.n_samples, 2))
    v = rng.standard_normal((ds.n_snps, 2))
    for got, want in ((d0["y"], X @ (X.T @ x)), (d0["w"], X @ v),
                      (d0["z"], X.T @ x), (d0["ff"], X @ (X.T @ x))):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(d0["trace"]), (X ** 2).sum(),
                               rtol=1e-10)
    # the one-process port and the JAX package's operator
    mean, sd = ds.snp_stats("binom2")
    one = ft.PackedOperator(ds.read_packed(), mean, sd, ds.n_samples,
                            device="cpu")
    jop = JPacked(ds.read_packed(), mean, sd, ds.n_samples,
                  dtype=np.float64, use_pallas=False)
    for ref in (one, jop):
        np.testing.assert_allclose(d0["y"], np.asarray(ref.perform_op(x)),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(d0["z"], np.asarray(ref.crossprod(x)),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(d0["w"], np.asarray(ref.prod(v)),
                                   rtol=1e-9, atol=1e-9)


def test_two_process_stats_exact(small_plink, runs):
    from flashpca_tpu.io.plink import PlinkDataset as JDataset

    jds = JDataset.open(small_plink[0])
    mean, sd = jds.snp_stats("binom2")
    moments = np.stack(jds.snp_moments())
    for d in runs["stats"]:
        assert d["mean"].dtype == np.float64
        np.testing.assert_array_equal(d["mean"], mean)
        np.testing.assert_array_equal(d["sd"], sd)
        np.testing.assert_array_equal(d["moments"], moments)


@pytest.mark.parametrize("mode,rtol,bar", [("pca", 1e-9, 1e-8),
                                           ("pca32", 2e-5, 1e-4)])
def test_two_process_full_solver(mp_pca_plink, runs, mode, rtol, bar):
    """The whole pca(): a starved run writes rank 0's state and raises on
    every process, the resumed run reads it; bit-identical across the
    processes, and equal to the one-process port and the JAX package."""
    import torch

    import flashpca_tpu_torch as ft
    from flashpca_tpu.models.pca import pca as jpca

    root = mp_pca_plink[0]
    d0, d1 = runs[mode]
    _lockstep(d0, d1, ("values", "vectors", "loadings", "pve", "trace",
                       "projection", "n_ops"))
    if mode == "pca":
        # the float64 solve cannot meet 1e-10 in one restart (the float32
        # contract gate may accept its capped solve at this size)
        assert not bool(d0["first_converged"])
    ds, X = _dense(root)
    lam, V = np.linalg.eigh(X @ X.T / ds.n_snps)
    np.testing.assert_allclose(d0["values"], lam[::-1][:5], rtol=rtol)
    assert _aligned_rmse(d0["vectors"], V[:, ::-1][:, :5]) < bar
    f32 = mode == "pca32"
    dt = torch.float32 if f32 else torch.float64
    mean, sd, sumsq = ds.snp_stats("binom2", with_sumsq=True)
    one = ft.pca(ft.PackedOperator(
        ds.read_packed(), mean, sd, ds.n_samples, snp_sumsq=sumsq,
        device="cpu", dtype=dt, use_kernels=True if f32 else None), 5,
        tol=1e-7, do_loadings=True)
    ref = jpca(root, 5, tol=1e-7, do_loadings=True,
               dtype=np.float32 if f32 else np.float64)
    for want in (one, ref):
        np.testing.assert_allclose(d0["values"], want.values, rtol=rtol)
        assert _aligned_rmse(d0["vectors"], np.asarray(want.vectors)) < bar
        np.testing.assert_allclose(float(d0["trace"]), want.trace,
                                   rtol=1e-10)


def test_two_process_scca(mp_pca_plink, runs):
    import flashpca_tpu_torch as ft
    from flashpca_tpu.models.scca import scca as jscca

    root, geno = mp_pca_plink
    d0, d1 = runs["scca"]
    _lockstep(d0, d1, ("U", "V", "d", "Px", "Py", "converged"))
    assert bool(d0["converged"])
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((geno.shape[0], 3))
    V0 = rng.standard_normal((3, 2))
    kw = dict(ndim=2, V0=V0, tol=1e-7, maxiter=500)
    one = ft.scca(root, Y, 1e-3, 1e-3, device="cpu", **kw)
    np.testing.assert_allclose(d0["d"], one.d, rtol=1e-9)
    np.testing.assert_allclose(d0["U"], one.U, atol=1e-8)
    np.testing.assert_allclose(d0["V"], one.V, atol=1e-8)
    ref = jscca(root, Y, 1e-3, 1e-3, **kw)
    np.testing.assert_allclose(d0["d"], ref.d, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(d0["U"], ref.U, atol=1e-8)
    np.testing.assert_allclose(d0["V"], ref.V, atol=1e-8)


def test_two_process_ucca(mp_pca_plink, runs):
    import flashpca_tpu_torch as ft
    from flashpca_tpu.models.ucca import ucca as jucca

    root, geno = mp_pca_plink
    d0, d1 = runs["ucca"]
    _lockstep(d0, d1, ("result",))
    Y = np.random.default_rng(0).standard_normal((geno.shape[0], 3))
    for ref in (ft.ucca(root, Y, device="cpu").result,
                jucca(root, Y).result):
        np.testing.assert_allclose(d0["result"], ref, rtol=1e-9,
                                   atol=1e-12)


def test_two_process_check(mp_pca_plink, runs):
    import flashpca_tpu_torch as ft
    from flashpca_tpu.models.check import check as jcheck

    root = mp_pca_plink[0]
    d0, d1 = runs["check"]
    _lockstep(d0, d1, ("err", "mse", "rmse", "values"))
    assert float(d0["mse"]) < 1e-12
    one = ft.pca(root, 4, tol=1e-9, device="cpu")
    np.testing.assert_allclose(d0["values"], one.values, rtol=1e-9)
    # the JAX checker on the same eigenpairs
    ref = jcheck(root, one.vectors, one.values)
    assert float(ref.mse) < 1e-12


@pytest.mark.parametrize("mode,rtol", [("tall", 1e-9), ("tall32", 2e-5),
                                       ("tallstream", 1e-9)])
def test_two_process_tall(mp_pca_plink, runs, mode, rtol):
    """Sample-sharded tall operators (resident, and streamed from the
    host in byte-column items of each block) across the processes."""
    import flashpca_tpu_torch as ft
    from flashpca_tpu.models.pca import pca as jpca

    root = mp_pca_plink[0]
    d0, d1 = runs[mode]
    _lockstep(d0, d1, ("gram", "values", "vectors", "pve", "trace", "n_ops"))
    ds, X = _dense(root)
    v = np.random.default_rng(0).standard_normal((ds.n_snps, 2))
    ref_u = X.T @ (X @ v)
    rel = np.linalg.norm(d0["gram"] - ref_u) / np.linalg.norm(ref_u)
    assert rel < (1e-5 if mode == "tall32" else 1e-12), rel
    f32 = mode == "tall32"
    kw = dict(operator_mode="tall", tol=1e-6 if f32 else 1e-9)
    one = ft.pca(root, 4, device="cpu", **kw)
    ref = jpca(root, 4, **kw)
    bar = 1e-4 if f32 else 1e-8
    for want in (one, ref):
        np.testing.assert_allclose(d0["values"], want.values, rtol=rtol)
        assert _aligned_rmse(d0["vectors"], np.asarray(want.vectors)) < bar
    np.testing.assert_allclose(float(d0["trace"]),
                               (X ** 2).sum() / ds.n_snps, rtol=1e-10)


if __name__ == "__main__":
    small, root, rank, nproc, port, outdir = sys.argv[1:7]
    _worker(small, root, int(rank), int(nproc), port, outdir)
