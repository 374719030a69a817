"""Milliseconds of a request from the start of the program's `tfhe.gate`
span to the first start of a device operation launched in its
`tfhe.rotation` span: the affine combination, the mod switch and the
rotation's prologue, as the request waits for them; the mean over the
traced requests (closed loop)."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    gates = view.spans.get("tfhe.gate")
    rot = view.by_unit(view.launched_in("tfhe.rotation"))
    if gates is None or len(rot) != len(view.units):
        return None
    waits = []
    for ops in rot.values():
        first = min(ops)
        g = gates.find(first[3])
        if g is None:
            return None
        waits.append(first[0] - gates.spans[g][0])
    return sum(waits) / len(waits) / 1e3
