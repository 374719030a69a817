"""Dots blocks an SM holds at once, as the program's work plan sized them
for the shared memory of one block at the cell's M: the mean r over the
traced stretch's dots calls, from the program's `dots.per_sm.<r>`
counters (one a C entry call, `tfhe_tpu_torch/ops/dots.py:dots_args`),
chained loop. None where the program counts no such calls."""

PREFIX = "dots.per_sm."


def read(run):
    if run.loop != "chained":
        return None
    calls = {int(name[len(PREFIX):]): n for name, n in run.launches.items()
             if name.startswith(PREFIX)}
    if not calls:
        return None
    return sum(r * n for r, n in calls.items()) / sum(calls.values())
