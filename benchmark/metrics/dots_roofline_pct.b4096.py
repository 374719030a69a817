"""The dots kernel's share of its roofline: the least time the card could
take for the rotations' int8 products (the larger of the fewest
operations over the int8 peak and the key's bytes over the HBM rate,
`benchmark/counts.py`, for each of the `rotations_per_row` rotations of
the unit of work) over the device time of the kernels named `*dots*`
launched in the program's `tfhe.rotation` spans, in the traced layers
(chained loop)."""

from benchmark import counts


def read(run):
    view = run.trace
    if run.loop != "chained" or view is None or not view.units:
        return None
    dots = [op for op in view.launched_in("tfhe.rotation")
            if "dots" in op[2]]
    if not dots:
        return None
    ops, key_bytes = counts.rotation_work(run.config, run.batch)
    rotations = len(view.units) * run.rotations_per_row
    least = rotations * max(ops / counts.INT8_OPS_PER_S,
                         key_bytes / counts.HBM_BYTES_PER_S)
    return 100.0 * least / view.seconds(dots)
