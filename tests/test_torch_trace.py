"""The port's ``flashpca/`` spans (flashpca_tpu_torch/utils/trace.py).

Tiny wide and tall operators on the CPU, float32 with
``use_kernels=True`` (the kernels' plain versions), run under
``torch.profiler``; the Chrome trace it exports is read back and its
``flashpca/`` spans are held to the tree the module documents: every
span present, each Lanczos step inside a cycle inside a solve inside
``pca``, one step a solver pass, one cycle a restart, one SCCA iteration
a counted one.  Without a profiler ``span()`` must not reach
``record_function`` at all.  The CLI's ``--profile DIR`` trace holds
the spans too.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flashpca_tpu_torch as ft
from flashpca_tpu_torch.cli import main as cli_main
from flashpca_tpu_torch.io.plink import (pack_codes, snp_stats_from_codes,
                                         write_bed)
from flashpca_tpu_torch.ops.operator import PackedOperator, TallPackedOperator
from flashpca_tpu_torch.utils import trace as ptrace

K = 3


def _dosage(n, p, seed):
    """(n, p) dosages of two populations, 2% missing (NaN)."""
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.1, 0.5, size=p)
    shift = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)[:, None]
    prob = np.clip(af[None, :] + 0.08 * shift, 0.02, 0.98)
    dose = rng.binomial(2, prob).astype(np.float64)
    dose[rng.random((n, p)) < 0.02] = np.nan
    return dose


def _operator(cls, n, p, seed):
    """A float32 ``cls`` on the CPU over ``_dosage``'s packed codes."""
    dose = _dosage(n, p, seed).T
    # PLINK's 2-bit codes: dosage 2 -> 0, 1 -> 2, 0 -> 3, missing -> 1
    codes = np.full(dose.shape, 3, dtype=np.uint8)
    codes[dose == 2] = 0
    codes[dose == 1] = 2
    codes[np.isnan(dose)] = 1
    mean, sd = snp_stats_from_codes(codes, "binom2")
    return cls(pack_codes(codes, n), mean, sd, n, device="cpu",
               dtype=torch.float32, use_kernels=True)


def _profiled(tmp_path, fn):
    """Run ``fn()`` under the profiler; its result and the trace's
    ``flashpca/`` spans as (start, end, name, tid) sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len(ptrace.PREFIX):], e.get("tid"))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(ptrace.PREFIX))
    return out, spans


def _parent(spans, s):
    """Name of the innermost span that encloses ``s`` on its thread."""
    inside = [o for o in spans if o is not s and o[3] == s[3]
              and o[0] <= s[0] and s[1] <= o[1]
              and (o[1] - o[0]) >= (s[1] - s[0])]
    if not inside:
        return None
    return min(inside, key=lambda o: o[1] - o[0])[2]


def _names(spans):
    return [s[2].split("@", 1)[0] for s in spans]


@pytest.fixture(scope="module")
def wide_op():
    return _operator(PackedOperator, 242, 130, 3)


@pytest.fixture(scope="module")
def tall_op():
    return _operator(TallPackedOperator, 601, 150, 4)


def test_span_is_shared_noop_without_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert ptrace.span("pca") is ptrace.span("op/gram", 16)
    with ptrace.span("lanczos/step"):
        pass


def test_span_names_carry_prefix_and_width(tmp_path):
    def run():
        with ptrace.span("op/gram", 16):
            with ptrace.span("lanczos/step"):
                torch.ones(4).sum()
        return ptrace.width(torch.ones(5)), ptrace.width(torch.ones(5, 7))

    widths, spans = _profiled(tmp_path, run)
    assert widths == (1, 7)
    assert [s[2] for s in spans] == ["op/gram@16", "lanczos/step"]
    assert _parent(spans, spans[1]) == "op/gram@16"


@pytest.mark.parametrize("which", ["wide", "tall"])
def test_pca_and_check_span_tree(tmp_path, which, wide_op, tall_op):
    op = wide_op if which == "wide" else tall_op

    def run():
        res = ft.pca(op, K, polish="contract", seed=5)
        chk = ft.check(wide_op, res.vectors, res.values) \
            if which == "wide" else None
        return res, chk

    (res, chk), spans = _profiled(tmp_path, run)
    names = _names(spans)
    want = {"pca", "pca/start", "lanczos/solve", "lanczos/start",
            "lanczos/draw", "lanczos/orth", "lanczos/cycle", "lanczos/step",
            "lanczos/ritz", "polish/sweep", "polish/refine", "polish/ritz",
            "pca/finish", "op/gram", "op/gram_ff"}
    if which == "wide":
        want |= {"check", "check/upload", "check/residual"}
        assert chk.mse < 1e-8
    assert want <= set(names), want - set(names)
    assert names.count("pca") == 1
    # one step a solver pass, one cycle a restart (no fallback ran)
    assert "pca/fallback" not in names
    assert names.count("lanczos/step") == res.n_ops
    assert names.count("lanczos/cycle") == res.n_restarts
    # the start panel: one host draw and one device QR a solve
    for nm in ("lanczos/start", "lanczos/draw", "lanczos/orth"):
        assert names.count(nm) == names.count("lanczos/solve"), nm
    for s in spans:
        nm = s[2].split("@", 1)[0]
        if nm == "lanczos/step":
            cycle = next(o for o in spans if o[2] == "lanczos/cycle"
                         and o[0] <= s[0] and s[1] <= o[1])
            assert _parent(spans, s) == "lanczos/cycle"
            assert _parent(spans, cycle) == "lanczos/solve"
            solve = next(o for o in spans if o[2] == "lanczos/solve"
                         and o[0] <= s[0] and s[1] <= o[1])
            assert _parent(spans, solve) == "pca"
        elif nm.startswith("op/"):
            # the width the product ran at, and a layer above it
            assert int(s[2].split("@", 1)[1]) >= 1
            assert _parent(spans, s) in (
                "lanczos/step", "polish/sweep", "polish/refine",
                "polish/ritz", "pca/finish", "check")
        elif nm in ("pca/start", "lanczos/solve", "pca/finish"):
            assert _parent(spans, s) == "pca"
        elif nm in ("lanczos/draw", "lanczos/orth"):
            assert _parent(spans, s) == "lanczos/start"
        elif nm in ("check/upload", "check/residual"):
            assert _parent(spans, s) == "check"
        elif nm == "polish/ritz":
            assert _parent(spans, s) == "polish/refine"


def test_scca_span_tree(tmp_path, wide_op):
    n = wide_op.n_samples
    rng = np.random.default_rng(8)
    Y = rng.standard_normal((n, 4))
    res, spans = _profiled(tmp_path, lambda: ft.scca(
        wide_op, Y, 1e-3, 1e-3, ndim=2, maxiter=200, tol=1e-4, seed=3,
        engine="device"))
    names = _names(spans)
    want = {"scca", "scca/setup", "scca/dim", "scca/iter", "scca/dim_end",
            "scca/result", "op/cross", "op/prod"}
    assert want <= set(names), want - set(names)
    assert names.count("scca") == 1
    assert names.count("scca/dim") == 2
    assert names.count("scca/iter") == int(np.sum(res.n_iters))
    for s in spans:
        nm = s[2].split("@", 1)[0]
        if nm in ("scca/iter", "scca/dim_end"):
            assert _parent(spans, s) == "scca/dim"
        elif nm in ("scca/setup", "scca/dim", "scca/result"):
            assert _parent(spans, s) == "scca"
        elif nm in ("op/cross", "op/prod"):
            assert _parent(spans, s) in ("scca/iter", "scca/dim_end",
                                         "scca/result")


def test_cli_profile_trace_holds_program_spans(tmp_path):
    n, p = 242, 130
    root = str(tmp_path / "data")
    write_bed(root, _dosage(n, p, 6))
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli_main(["--bfile", root, "--ndim", "2", "--device", "cpu",
                         "--profile", "trace", "--notime"]) == 0
    finally:
        os.chdir(old)
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"flashpca/pca", "flashpca/lanczos/step"} <= names
