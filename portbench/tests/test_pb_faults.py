"""A whole run on the CPU at a tiny size, with the kernels' plain
versions: a sound run comes out correct, the program's lower-precision
path (the control) and the timed path broken underneath do not."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import run_tiny
from portbench import run


def test_sound_run_is_correct():
    res = run_tiny("wide500k.pca20")
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"decomp_s", "peak_dev_gb", "setup_s"}


def test_sound_tall_run_is_correct():
    res = run_tiny("tall1m.pca20")
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("cell", ["wide500k.pca20", "tall1m.pca20"])
def test_control_is_not_correct(cell):
    """The program's plain float32 polish and check in place of the
    two-float ones."""
    res = run_tiny(cell, control=True)
    assert not res["correct"], res["compared"]


def unchanged(cohort, kind):
    """A solver step that returns its state unchanged."""
    cohort.op.gram_permuted = lambda x: x.clone()


def half_batch(cohort, kind):
    """The gram over the first half of the SNPs, doubled: half of the
    data left out, the mean taken over the rest."""
    from flashpca_tpu_torch import PackedOperator

    op = cohort.op
    h = op.n_snps // 2
    half = PackedOperator(op.packed[:h], op.center[:h], op.scale[:h],
                          op.n_samples, device=op.device, dtype=op.dtype,
                          use_kernels=op.use_kernels)
    cohort.op.gram_permuted = lambda x: 2 * half.gram_permuted(x)
    cohort.op.gram_ff_permuted = lambda x: tuple(
        2 * t for t in half.gram_ff_permuted(x))


def altered_answer(cohort, kind):
    """An answer altered where it is produced: one entry of the first
    eigenvector that pca() returns."""
    real = kind.run

    def run_job(i, rec):
        job = real(i, rec)
        job["U"] = job["U"].copy()
        job["U"][0, 0] += 0.1
        return job
    kind.run = run_job


def altered_check(cohort, kind):
    """check()'s reported statistic altered where it is produced."""
    real = kind.run

    def run_job(i, rec):
        job = real(i, rec)
        job["mse"] *= 2
        return job
    kind.run = run_job


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_answer,
                                   altered_check])
def test_broken_path_is_not_correct(fault):
    res = run_tiny("wide500k.pca20", fault=fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [altered_answer, altered_check])
def test_broken_tall_path_is_not_correct(fault):
    res = run_tiny("tall1m.pca20", fault=fault)
    assert not res["correct"], res["compared"]


def test_result_line_keys():
    res = run_tiny("wide500k.pca20", trace=True)
    line = run.result_line(res, "cpu", 1, True)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
    for k, v in line["compared"].items():
        assert set(v) == {"value", "limit"} and np.isfinite(v["value"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # no device ran: no share of a roofline or of the peak is made up
    assert not any("roofline" in k for k in line["metrics"])
    assert len(line["breakdown"]["device_ops"]) <= 10


def test_sound_scca_run_is_correct():
    res = run_tiny("wide500k.scca")
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"scca_fit_s", "peak_dev_gb", "setup_s"}


def test_scca_control_is_not_correct():
    """The reference in the program's place, its products' inputs
    rounded to TF32."""
    res = run_tiny("wide500k.scca", control=True)
    assert not res["correct"], res["compared"]


def scca_unchanged(cohort, kind):
    """SCCA's u-step returns its input panel unchanged (padded to p)."""
    import torch

    op = cohort.op
    op._cross_p = lambda xp: torch.zeros(
        (op.n_snps, xp.shape[1]), dtype=xp.dtype, device=xp.device) + \
        xp[: op.n_snps]


def scca_half_batch(cohort, kind):
    """X u over the first half of the SNPs, doubled."""
    op = cohort.op
    real = op._mv_p

    def half(v2):
        v2 = v2.clone()
        v2[op.n_snps // 2:] = 0
        return 2 * real(v2)
    op._mv_p = half


def scca_half_samples(cohort, kind):
    """X^T y over the first half of the (permuted) samples, doubled."""
    op = cohort.op
    real = op._cross_p

    def half(xp):
        xp = xp.clone()
        xp[xp.shape[0] // 2:] = 0
        return 2 * real(xp)
    op._cross_p = half


def scca_altered(cohort, kind):
    """A fit's d altered where it is produced."""
    real = kind.run

    def run_job(i, rec):
        job = real(i, rec)
        job["d"] = job["d"] * 1.001
        return job
    kind.run = run_job


@pytest.mark.parametrize("fault", [scca_unchanged, scca_half_batch,
                                   scca_half_samples, scca_altered])
def test_broken_scca_is_not_correct(fault):
    res = run_tiny("wide500k.scca", fault=fault)
    assert not res["correct"], res["compared"]
