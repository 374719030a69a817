"""The dots kernel's share of its roofline: the least time the card could
take for the rotation's int8 products (the larger of the fewest
operations over the int8 peak and the key's bytes over the HBM rate,
`benchmark/counts.py`) over the device time of the kernels named `*dots*`
that the rotation launched, in the traced layers (chained loop)."""

from benchmark import counts


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    dots = [op for op in view.launched_in("layer.rotation")
            if "dots" in op[2]]
    if not dots:
        return None
    ops, key_bytes = counts.rotation_work(run.config, run.batch)
    layers = len(view.units)
    least = layers * max(ops / counts.INT8_OPS_PER_S,
                         key_bytes / counts.HBM_BYTES_PER_S)
    return 100.0 * least / view.seconds(dots)
