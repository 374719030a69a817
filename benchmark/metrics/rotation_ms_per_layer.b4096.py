"""Device milliseconds a layer spends in the blind rotation: every device
operation launched inside the program's `tfhe.rotation` span (the body of
`bootstrap.blind_rotate` and `mk.internals.mk_blind_rotate`, whichever
path calls them), over the traced layers (chained loop)."""


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    ops = view.launched_in("tfhe.rotation")
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / len(view.units)
