"""Share of the roofline SCCA's one-column products take, %."""

from portbench import readings


def read(run):
    return readings.roofline_pct(run, "narrow")
