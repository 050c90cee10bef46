"""The port's PackedOperator against the JAX package's PackedOperator
and the float64 dense oracle.

Both operators are built from the same numpy arrays (raw packed bytes,
float64 center and scale) through ``packed_operator_from_numpy``.  The
fileset has n % 4 == 3, so the last byte of every SNP carries one
garbage sample position that both operators must mask on input and
output, missing calls, and one constant SNP (inv_sd == 0).

Tolerances: float64 paths agree with each other and with the dense
oracle to 1e-12 relative (same math, another summation order); float32
paths to 1e-5 relative in norm (float32 accumulation over a few hundred
terms); the two-float gram, compared through hi + lo, to the float64
product at 5e-6 relative (test_compensated.py's bar).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flashpca_tpu.io.plink import PlinkDataset as JPlinkDataset
from flashpca_tpu.io.plink import write_bed
from flashpca_tpu.ops.operator import PackedOperator as JPackedOperator
from flashpca_tpu_torch.io.plink import PlinkDataset as TPlinkDataset
from flashpca_tpu_torch.ops.genotypes import dense_standardized_np
from flashpca_tpu_torch.ops.operator import (PackedOperator,
                                             TallPackedOperator,
                                             build_packed_operator,
                                             packed_operator_from_numpy)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(17)
    n, p = 203, 150
    freq = rng.uniform(0.05, 0.5, p)
    geno = rng.binomial(2, freq[None, :], size=(n, p)).astype(np.float64)
    geno[rng.uniform(size=geno.shape) < 0.03] = np.nan
    geno[:, 9] = 2.0                                    # a constant SNP
    root = str(tmp_path_factory.mktemp("op") / "d")
    write_bed(root, geno)
    ds = JPlinkDataset.open(root)
    mean, sd = ds.snp_stats("binom2")
    packed = ds.read_packed()
    X = dense_standardized_np(ds.read_codes(), mean, sd).T     # (n, p)
    return dict(root=root, n=n, p=p, packed=packed, mean=mean, sd=sd, X=X,
                rng=rng)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _t(op, a):
    return torch.as_tensor(np.asarray(a), dtype=op.dtype)


def _products(op, x, v, as_arg):
    """Sample-space products of either operator, as float64 numpy."""
    def np64(a):
        if isinstance(a, torch.Tensor):
            return a.to(torch.float64).numpy()
        return np.asarray(a, dtype=np.float64)

    hi, lo = op.perform_op_ff(as_arg(x))
    return {
        "perform_op": np64(op.perform_op(as_arg(x))),
        "crossprod": np64(op.crossprod(as_arg(x))),
        "prod": np64(op.prod(as_arg(v))),
        "perform_op_ff": np64(hi) + np64(lo),
        "trace": op.trace,
    }


CASES = [
    # (port dtype, port use_kernels, JAX dtype, JAX use_pallas, tolerance)
    ("float64", False, "float64", False, 1e-12),
    ("float32", False, "float32", False, 1e-5),
    ("float32", True, "float32", "interpret", 1e-5),
]


@pytest.mark.parametrize("tdt,kern,jdt,pallas,tol", CASES)
def test_products_match_jax_and_dense(data, tdt, kern, jdt, pallas, tol):
    n, p, X = data["n"], data["p"], data["X"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 3))
    v = rng.standard_normal((p, 2))
    top = packed_operator_from_numpy(
        data["packed"], data["mean"], data["sd"], n, device="cpu",
        dtype=getattr(torch, tdt), use_kernels=kern)
    jop = JPackedOperator(data["packed"], data["mean"], data["sd"], n,
                          dtype=getattr(jnp, jdt), use_pallas=pallas)
    assert top.op_dim == 4 * ((n + 3) // 4)
    got = _products(top, x, v, lambda a: _t(top, a))
    want = _products(jop, x, v, lambda a: jnp.asarray(a, jop.dtype))
    dense = {"perform_op": X @ (X.T @ x), "crossprod": X.T @ x,
             "prod": X @ v, "perform_op_ff": X @ (X.T @ x),
             "trace": float(np.sum(X * X))}
    for name in ("perform_op", "crossprod", "prod", "trace"):
        assert _rel(got[name], want[name]) < tol, name
        assert _rel(got[name], dense[name]) < tol, name
    # the two-float gram is float64-grade whatever the working dtype
    assert _rel(got["perform_op_ff"], dense["perform_op_ff"]) < 5e-6
    assert _rel(got["perform_op_ff"], want["perform_op_ff"]) < 5e-6
    assert top.nops == 4 and top.stats()["nops"] == 4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vector_inputs_and_precomputed_sumsq(data, dtype):
    n, p, X = data["n"], data["p"], data["X"]
    dt = getattr(torch, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    sumsq = np.sum(X * X, axis=0)
    op = packed_operator_from_numpy(data["packed"], data["mean"], data["sd"],
                                    n, device="cpu", dtype=dt,
                                    snp_sumsq=sumsq)
    x = np.random.default_rng(2).standard_normal(n)
    y = op.perform_op(torch.as_tensor(x, dtype=dt))
    assert y.shape == (n,)
    assert _rel(y.numpy(), X @ (X.T @ x)) < tol
    z = op.crossprod(torch.as_tensor(x, dtype=dt))
    assert z.shape == (p,) and _rel(z.numpy(), X.T @ x) < tol
    # the precomputed sums of squares make trace free and exact
    assert np.array_equal(op.snp_sumsq, sumsq)
    assert op.trace == float(sumsq.sum())
    with pytest.raises(ValueError):
        packed_operator_from_numpy(data["packed"], data["mean"], data["sd"],
                                   n, device="cpu", snp_sumsq=sumsq[:-1])


@pytest.mark.parametrize("kern", [False, True])
def test_gram_masks_padding_and_stays_symmetric(data, kern):
    n = data["n"]
    op = packed_operator_from_numpy(
        data["packed"], data["mean"], data["sd"], n, device="cpu",
        dtype=torch.float64 if not kern else torch.float32,
        use_kernels=kern)
    pad = op._valid == 0
    assert int(pad.sum()) == op.op_dim - n == 1
    g = torch.Generator().manual_seed(3)
    # random permuted-space panels carry garbage at the padding position
    a = torch.randn((op.op_dim, 2), generator=g, dtype=op.dtype)
    b = torch.randn((op.op_dim, 2), generator=g, dtype=op.dtype)
    ga, gb = op.gram_permuted(a), op.gram_permuted(b)
    assert bool((ga[pad] == 0).all()) and bool((gb[pad] == 0).all())
    lhs = (b.T @ ga).double()
    rhs = (a.T @ gb).double().T
    tol = 1e-12 if not kern else 1e-5
    assert float((lhs - rhs).norm() / lhs.norm()) < tol
    hi, lo = op.gram_ff_permuted(a)
    assert bool((hi[pad] == 0).all()) and bool((lo[pad] == 0).all())


@pytest.mark.parametrize("p,nbytes,dt", [(150, 51, "float64"),
                                         (100_352, 125_440, "float32"),
                                         (37, 16, "float32")])
def test_plan_layout_matches_jax_jnp_path(p, nbytes, dt):
    want = JPackedOperator.plan_layout(p, nbytes, dtype=getattr(jnp, dt),
                                       use_pallas=False)
    got = PackedOperator.plan_layout(p, nbytes, dtype=getattr(torch, dt))
    assert got["block_size"] == want["block_size"]
    assert got["nbytes_pad"] == want["nbytes_pad"] == nbytes
    # no SNP padding: the kernels mask the ragged last tile themselves
    assert got["p_pad"] == p


def test_build_packed_operator_resident_only(data):
    ds = TPlinkDataset.open(data["root"])
    op = build_packed_operator(ds, data["mean"], data["sd"], device="cpu")
    assert isinstance(op, PackedOperator) and op.dtype == torch.float64
    top = build_packed_operator(ds, data["mean"], data["sd"], tall=True,
                                device="cpu")
    assert isinstance(top, TallPackedOperator) and top.op_dim == data["p"]
    for tall in (False, True):
        with pytest.raises(NotImplementedError, match="A15"):
            build_packed_operator(ds, data["mean"], data["sd"], tall=tall,
                                  streaming=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A18"):
        build_packed_operator(ds, data["mean"], data["sd"], mesh=object(),
                              device="cpu")
    with pytest.raises(ValueError):
        PackedOperator(data["packed"][:, :-1], data["mean"], data["sd"],
                       data["n"], device="cpu")
    with pytest.raises(ValueError):
        PackedOperator(data["packed"], data["mean"], data["sd"], data["n"],
                       device="cpu", dtype=torch.float64, use_kernels=True)
    stats = op.stats()
    assert stats["packed_bytes"] == data["packed"].size
    assert set(stats["kernel_launches"]) == {"crossprod", "matvec",
                                             "crossprod_ff", "matvec_ff",
                                             "matvec_ff_novl"}
