"""Device milliseconds a layer spends in the keyswitch: every device
operation launched inside the program's `tfhe.keyswitch` span (the body
of `keyswitch.keyswitch` and `mk.internals.mk_keyswitch`, whichever path
calls them), over the traced layers (chained loop)."""


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    ops = view.launched_in("tfhe.keyswitch")
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / len(view.units)
