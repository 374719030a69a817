"""The median wait of one tenant's request, from its issue to its output
on the host, over every request of the window (closed loop)."""

from benchmark import stats


def read(run):
    if run.loop != "closed" or not run.latencies_s:
        return None
    return 1e3 * stats.percentile(run.latencies_s, 50)
