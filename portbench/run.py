#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload wide500k.pca20 --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  Set-up generates the cell's cohort on the card from
``--seed``, builds the program's operator and runs one warm-up job; the
window then runs jobs back to back (one client, a closed loop) until
``--seconds`` have passed, the job in flight at the deadline finishing
and counting.  After the window every job's answer is held to the
float64 reference (reference.py).  The last line of standard output is
the result, as JSON; the numbers compared, each beside its limit, are
the last lines of standard error.

``--trace 1`` runs the window under ``torch.profiler`` and reports the
cell's per-layer metrics instead of its end-to-end ones.  ``--control``
runs the program's lower-precision path in place of the configured one
(the correctness control; never part of a benchmark run).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# one process with few threads: the host's BLAS and OpenMP pools keep
# one thread, so that the solver's small dense steps on a shared host do
# not wait on pool threads that were descheduled
for _pool in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_pool, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "flashpca_tpu")
WINDOW = "portbench/window"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``flashpca_tpu_torch`` is not)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_readings() -> str:
    """The card's name, power limit, clocks, draw and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


class Run:
    """What a cell's run hands to the per-layer metric readers: the
    window's jobs, the product calls and the trace."""

    def __init__(self, jobs, calls, trace):
        self.jobs = jobs
        self.calls = calls
        self.trace = trace


def drive(cell, seed: int, seconds: float, trace: bool, device,
          control: bool = False, cpu_kernels: bool = False,
          fault=None) -> dict:
    """One run of ``cell``: set-up, warm-up, the window, the judgement.
    Returns the result object (without ``device``).  ``fault``, for the
    harness's own tests, is called with the set-up's cohort and job
    kind before the window to break the timed path."""
    import numpy as np
    import torch

    from portbench import manifest, spans
    from portbench import trace as trace_mod

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    phases = {"start": time.perf_counter() - T_START}
    t = time.perf_counter()
    cohort = manifest.cohort(cell.config["cohort"])(
        cell.config, seed, device, cpu_kernels=cpu_kernels)
    sync()
    phases["cohort"] = time.perf_counter() - t
    t = time.perf_counter()
    kind = manifest.kind(cell.traffic["job"])(cell.traffic, cohort,
                                              control=control)
    rec = spans.Recorder(trace)
    for op in cohort.operators():
        rec.wrap(op, cohort.products)
    if fault is not None:
        fault(cohort, kind)
    sync()
    phases["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    # warm-up: one whole job, from a start seed no window job uses (the
    # control's jobs are not timed and go without)
    if not control:
        kind.run(-1, spans.Recorder(False))
    sync()
    phases["warm_up"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec.calls.clear()

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    done, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    deadline = t0 + seconds
    with (torch.profiler.record_function(WINDOW) if trace
          else contextlib.nullcontext()):
        while True:
            attempted += 1
            try:
                done.append(kind.run(len(done), rec))
            except (RuntimeError, ValueError, FloatingPointError) as e:
                failed += 1
                say(f"job {attempted - 1} failed: {type(e).__name__}: {e}")
            if time.perf_counter() >= deadline:
                break
        sync()
    t1 = time.perf_counter()
    window_s = t1 - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = trace_mod.load(path, WINDOW)
        del prof

    # the reference runs after the peak is read and the program's
    # operators are freed
    cohort.free_program()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    readings = (kind.judge(done, cell.traffic.get("limits", {})
                           | cell.config.get("limits", {}))
                if done else {"no_job_done": (1.0, 0.0)})
    judge_s = time.perf_counter() - t2
    compared = {k: v for k, v in readings.items() if v[1] is not None}
    correct = failed == 0 and all(v <= lim for v, lim in compared.values())

    # the per-layer metrics, and any end-to-end one but the traffic's
    # time a job, the peak and the set-up, come from their readers
    run = Run(done, list(rec.calls), tr)
    values = {cell.traffic["metric"]: window_s / max(1, len(done)),
              "peak_dev_gb": window_peak / 1e9, "setup_s": setup_s}
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = (values[m["name"]] if m["name"] in values
             else manifest.reader(m["name"])(run))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "jobs": [{k: v for k, v in j.items() if np.ndim(v) == 0}
                    for j in done],
           "judge_s": judge_s, "setup_phases": phases,
           "readings": {k: v for k, (v, _) in readings.items()},
           "compared": {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}}
    if tr is not None:
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    return out


def result_line(res: dict, kind: str, count: int, trace: bool) -> dict:
    """The result's line: the contract's keys, then ``compared`` last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = res["compared"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import manifest

    cell = manifest.Cell(manifest.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); this "
            f"machine has {torch.cuda.device_count()}: no result")
        return 2
    print(f"card: {card_readings()}", flush=True)
    res = drive(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                control=args.control)
    bad = forbidden_modules()
    if bad:
        say(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    print(f"card after the window: {card_readings()}", flush=True)
    print("set-up: " + json.dumps(res["setup_phases"]), flush=True)
    print("jobs: " + json.dumps(res["jobs"]), flush=True)
    print(f"reference: {res['judge_s']:.3f} s, readings "
          + json.dumps(res["readings"]), flush=True)
    line = result_line(res, torch.cuda.get_device_name(0), cell.chips,
                       bool(args.trace))
    for k, v in line["compared"].items():
        say(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
