"""Gate bootstraps completed per second: every gate of the window's
layers over the whole window, from the first layer's issue to the
synchronise that ends it (chained loop)."""

from benchmark import stats


def read(run):
    if run.loop != "chained":
        return None
    return stats.rate(run.units * run.batch, run.window_s)
