"""Device milliseconds a gate layer spends in the keyswitch: every device
operation launched inside the program's keyswitch call
(`bootstrap.keyswitch`, `mk.internals.mk_keyswitch`), over the traced
layers (chained loop)."""


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    ops = view.launched_in("layer.keyswitch")
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / len(view.units)
