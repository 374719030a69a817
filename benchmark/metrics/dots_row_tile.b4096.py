"""Batch rows a dots block owns, as the program's work plan chose them at
the cell's M and batch (64: one consumer warpgroup; 128: two that share
each key tile): the mean r over the traced stretch's dots calls, from the
program's `dots.row_tile.<r>` counters (one a C entry call,
`tfhe_tpu_torch/ops/dots.py:dots_args`), chained loop. None where the
program counts no such calls."""

PREFIX = "dots.row_tile."


def read(run):
    if run.loop != "chained":
        return None
    calls = {int(name[len(PREFIX):]): n for name, n in run.launches.items()
             if name.startswith(PREFIX)}
    if not calls:
        return None
    return sum(r * n for r, n in calls.items()) / sum(calls.values())
