"""Milliseconds of a request from the last end of a device operation
launched in the program's `tfhe.rotation` span to the last end of one
launched in its `tfhe.gate` span: the extraction and the keyswitch, the
card's idle between them included; the mean over the traced requests
(closed loop)."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    rot = view.by_unit(view.launched_in("tfhe.rotation"))
    gate = view.by_unit(view.launched_in("tfhe.gate"))
    if len(rot) != len(view.units) or len(gate) != len(view.units):
        return None
    tails = [max(op[1] for op in gate[u]) - max(op[1] for op in rot[u])
             for u in rot]
    return sum(tails) / len(tails) / 1e3
