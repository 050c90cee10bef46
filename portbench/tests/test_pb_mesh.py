"""The four-card cell on the CPU at 4,000 x 4,096 over four CPU shards
(the mesh repeats the CPU, which splits the work as four cards would):
its cohort is ``gen.generate``'s, its reference the unsharded one's, a
sound run is correct and one that drops a shard's partial is not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench import gen, reference, run

CELL = "ukb-array-805k.pca20"
SEED = 2**31 + 23


def mesh_cell():
    """The cell at 4,000 x 4,096.  Its ``mse_f64`` limit was set from the
    full size's readings (PERF.md); here a sound run reads ~5e-9, so the
    tiny size holds the statistic to the configuration's contract."""
    cell = tiny_cell(CELL)
    cell.config["n_snps"] = 4096
    cell.config["limits"] = dict(cell.config["limits"], mse_f64=1e-8)
    return cell


def cohort(cell=None, seed=SEED):
    from portbench import manifest

    cell = cell or mesh_cell()
    return manifest.cohort(cell.config["cohort"])(cell.config, seed, "cpu",
                                                  cpu_kernels=True)


def test_shards_are_the_generated_cohort():
    cfg = mesh_cell().config
    c = cohort()
    whole = gen.generate(cfg["n_samples"], cfg["n_snps"], SEED,
                         cfg["structure"], "cpu")
    assert len(c.shards) == 4 and c.op.nshards == 4
    assert torch.equal(torch.cat(c.shards), whole.packed)
    np.testing.assert_array_equal(c.snp_index, whole.snp_index)


def test_sharded_reference_is_the_unsharded_one():
    c = cohort()
    U = torch.randn((c.n, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    whole = torch.cat(c.shards)
    want = reference.gram_columns(whole, c.n,
                                  *reference.binom2_stats(whole, c.n), U)
    got = c.gram_columns(U)
    assert float((got - want).norm() / want.norm()) < 1e-12


def test_sound_run_is_correct_and_counts_the_copies():
    res = run.drive(mesh_cell(), SEED, 0.5, True, "cpu", cpu_kernels=True)
    assert res["correct"], res["compared"]
    jobs = res["jobs"]
    assert jobs and all(j["shards"] == 4 for j in jobs)
    assert all(j["xcard_bytes"] > 0 and j["xcard_copies"] > 0 for j in jobs)
    # the CPU's trace holds no device operation: the kernel shares and
    # the cards at work read nothing there
    assert {"n_ops.decomp", "check_s.decomp",
            "xcard_mb_per_pass.mesh"} <= set(res["metrics"])


def drop_shard(cohort, kind):
    """The last shard's partial left out of every gram the program
    computes (plain and two-float), as if its card's copy home were
    lost."""
    op = cohort.op
    real = op._partials

    def dropped(*args):
        return list(real(*args))[:-1]

    for name in ("_gram_raw", "_ff_raw"):
        def without(x, raw=getattr(op, name)):
            op._partials = dropped
            try:
                return raw(x)
            finally:
                del op._partials
        setattr(op, name, without)


def test_dropped_shard_is_not_correct():
    res = run.drive(mesh_cell(), SEED, 0.5, False, "cpu", cpu_kernels=True,
                    fault=drop_shard)
    assert res["failed"] == 0
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("mode", ["tall"])
def test_tall_mode_is_refused(mode):
    cell = mesh_cell()
    cell.config["operator_mode"] = mode
    with pytest.raises(ValueError, match="wide gram"):
        cohort(cell)
