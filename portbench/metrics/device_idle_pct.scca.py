"""Share of the traced window in which no device operation ran, %."""

from portbench import readings


def read(run):
    return readings.idle_pct(run)
