"""The share of the traced stretch in which no operation ran on the card:
from the first layer's issue to the last layer's last device operation
(chained loop)."""


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.window_s():
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s())
