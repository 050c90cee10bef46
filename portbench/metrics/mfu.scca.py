"""The products' least time over the traced window: the whole fit's
share of the card's peaks, %."""

from portbench import readings


def read(run):
    return readings.mfu_pct(run)
