"""Device operations (kernels, copies, sets) a request launches: those
whose launch call lies in a traced request's span, over the requests
(closed loop)."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    ops = view.by_unit(view.ops)
    return sum(len(v) for v in ops.values()) / len(view.units)
