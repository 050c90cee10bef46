"""SCCA iterations a fit: sum(SCCAResult.n_iters), the mean over the
window's fits."""

from portbench import readings


def read(run):
    return readings.mean_of(run, "iters")
