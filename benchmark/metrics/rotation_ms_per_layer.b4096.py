"""Device milliseconds a gate layer spends in the blind rotation: every
device operation launched inside the program's rotation call
(`bootstrap.blind_rotate`, `mk.internals.mk_blind_rotate`), over the
traced layers (chained loop)."""


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    ops = view.launched_in("layer.rotation")
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / len(view.units)
