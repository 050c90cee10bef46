"""Arithmetic the per-layer metric readers share (metrics/*.py).

Each reader takes the run (run.py's ``Run``: the window's jobs, the
product calls the benchmark wrapped and the reduced trace) and returns a number, or None where the run holds
nothing to read; a share of a roofline is never returned as 0 for want
of a reading.
"""

from __future__ import annotations

from . import roofline

def mean_of(run, key):
    vals = [j[key] for j in run.jobs if j.get(key) is not None]
    return sum(vals) / len(vals) if vals else None


def least_seconds(calls) -> float:
    return sum(roofline.least_seconds(c.flops, c.nbytes)[0] for c in calls)


def roofline_pct(run, group):
    """Least time of the product calls of ``group`` (the cohort table's)
    over the device time of every operation launched inside their spans,
    in %."""
    if run.trace is None:
        return None
    calls = [c for c in run.calls if c.group == group]
    dev = run.trace.device_by_span({c.span for c in calls})
    busy = sum(dev.get(c.span, 0.0) for c in calls)
    if not calls or busy <= 0:
        return None
    return 100.0 * least_seconds(calls) / busy


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run):
    """Least time of every product the window's jobs called, over the
    traced window's length on the trace's clock: the whole job's share
    of the card's peaks, in %."""
    if run.trace is None or not run.calls or run.trace.window_s <= 0:
        return None
    return 100.0 * least_seconds(run.calls) / run.trace.window_s


def host_gap_ms_per_pass(run, entry):
    """Device idle time inside the ``entry`` spans, ms a solver pass."""
    ops = sum(j["n_ops"] for j in run.jobs)
    if run.trace is None or ops == 0:
        return None
    return 1e3 * run.trace.idle_in(entry) / ops
