"""The share of the traced requests' time in which no operation ran on the
card: from the first request's issue to the last one's output on the host
(closed loop)."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.window_s():
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s())
