"""Device milliseconds a request spends in the keyswitch: every device
operation launched in the program's `tfhe.keyswitch` span (the digits,
the one-hot operand, the `_int_mm` and the limb fold), over the traced
requests (closed loop)."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    ks = view.by_unit(view.launched_in("tfhe.keyswitch"))
    if len(ks) != len(view.units):
        return None
    return 1e3 * sum(view.seconds(ops) for ops in ks.values()) / len(ks)
