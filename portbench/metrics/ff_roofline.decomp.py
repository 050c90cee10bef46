"""Share of the roofline the two-float grams take, %."""

from portbench import readings


def read(run):
    return readings.roofline_pct(run, "ff")
