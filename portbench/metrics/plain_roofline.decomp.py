"""Share of the roofline the plain products (grams, crossprod, prod) take,
%."""

from portbench import readings


def read(run):
    return readings.roofline_pct(run, "plain")
