"""Seconds a check() call, host clock ending in a synchronize, mean over
the jobs."""

from portbench import readings


def read(run):
    return readings.mean_of(run, "check_s")
