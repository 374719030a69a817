"""Gate bootstraps completed per second: every row of the window's layers
times the blind rotations a row runs (`rotations_per_row` of the unit of
work: 1 for a NAND gate), over the whole window, from the first layer's
issue to the synchronise that ends it (chained loop)."""

from benchmark import stats


def read(run):
    if run.loop != "chained":
        return None
    return stats.rate(run.units * run.batch * run.rotations_per_row,
                      run.window_s)
