"""Host microseconds a rotation step takes to enqueue: the program's
`tfhe.enqueue` spans (the rotation wrappers' C calls, which enqueue the
rotation's launches) of each traced request, over the steps of a
rotation (`benchmark/counts.py`) times the `rotations_per_row` of the
unit of work; the mean over the requests (closed loop). Below the card's
time a step, the host keeps ahead."""

import bisect

from benchmark import counts


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    enqueue = view.spans.get("tfhe.enqueue")
    if enqueue is None:
        return None
    starts = [start for start, _ in view.units]
    per_unit = {}
    for start, end in enqueue.spans:
        u = bisect.bisect_right(starts, start) - 1
        if u >= 0 and start <= view.units[u][1]:
            per_unit[u] = per_unit.get(u, 0.0) + (end - start)
    if len(per_unit) != len(view.units):
        return None
    steps = run.rotations_per_row * counts.steps_per_rotation(run.config)
    return sum(per_unit.values()) / (len(per_unit) * steps)
