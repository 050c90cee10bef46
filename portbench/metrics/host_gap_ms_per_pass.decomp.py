"""Device idle time inside the window's pca() spans, ms a solver pass."""

from portbench import readings


def read(run):
    return readings.host_gap_ms_per_pass(run, "pca")
