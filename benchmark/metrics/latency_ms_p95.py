"""The 95th percentile of the request latencies: the tail of every
request of the window, not of chunks (closed loop)."""

from benchmark import stats


def read(run):
    if run.loop != "closed" or not run.latencies_s:
        return None
    return 1e3 * stats.percentile(run.latencies_s, 95)
