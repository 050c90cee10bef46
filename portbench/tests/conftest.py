"""Fixtures of the benchmark's own tests: cells cut to a size the CPU
runs in seconds, and the card check of the tests marked ``cuda``."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small enough for the CPU, large enough that k = 20 and the contract
# path run as on the card
TINY = {"n_samples": 4000, "n_snps": 1024}
# the limits at this size, set from its own readings as the cells' are
# from theirs (PERF.md): sound runs read check_gap up to 3.5e-5,
# fixed_du ~4.7e-7, fixed_dv ~9e-8 and d_rel ~4e-7; the controls
# 2.7e-4 or more, 1.7e-4, 6.7e-6 and 9e-5.  The statistic itself is
# ~1e-9 here or less, its float32 floor far below the contract, so
# mse_f64 keeps the cells' limit.
TINY_LIMITS = {"check_gap": 1e-4, "fixed_du": 1e-5, "fixed_dv": 1e-6,
               "d_rel": 1e-5}


def tiny_cell(name: str, **config):
    """The cell at the tiny size, each of its limits but the contract's
    replaced by the tiny size's own."""
    from portbench import manifest

    def tiny(limits):
        return {k: TINY_LIMITS.get(k, v) for k, v in limits.items()}

    cell = manifest.Cell(manifest.load_benchmark(), name)
    cell.config = dict(cell.config, **TINY, **config)
    cell.config["limits"] = tiny(cell.config["limits"])
    cell.traffic = dict(cell.traffic, limits=tiny(
        cell.traffic.get("limits", {})))
    if cell.traffic["job"] == "scca":
        cell.traffic["planted"] = 20
    return cell


def run_tiny(name: str, seed: int = 2**31 + 5, **kw):
    from portbench import run

    return run.drive(tiny_cell(name), seed, 0.5, kw.pop("trace", False),
                     "cpu", cpu_kernels=True, **kw)


@pytest.fixture()
def card():
    """Skips a test marked ``cuda`` on a machine without a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
