"""Device microseconds of the dots kernel (kernels named `*dots*`
launched in the program's `tfhe.rotation` spans) a rotation step, over
the traced requests' steps: `rotations_per_row` rotations a request
(closed loop)."""

from benchmark import counts


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    dots = [op for op in view.launched_in("tfhe.rotation")
            if "dots" in op[2] and view.unit_of(op) is not None]
    if not dots:
        return None
    steps = (len(view.units) * run.rotations_per_row
             * counts.steps_per_rotation(run.config))
    return 1e6 * view.seconds(dots) / steps
