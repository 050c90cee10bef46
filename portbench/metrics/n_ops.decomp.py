"""Solver passes a job: PCAResult.n_ops, the mean over the window's jobs."""

from portbench import readings


def read(run):
    return readings.mean_of(run, "n_ops")
