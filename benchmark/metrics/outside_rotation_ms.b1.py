"""Milliseconds of a request outside the rotation: its span on the host
(issue to output on the host) less the device span of the operations
launched in the program's `tfhe.rotation` spans (first start to last
end), the mean over the traced requests (closed loop). What is left is
the mod switch, the extraction, the keyswitch, the copy and the host's
own time."""


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    rot = view.by_unit(view.launched_in("tfhe.rotation"))
    if len(rot) != len(view.units):
        return None
    outside = [(end - start) - (max(op[1] for op in rot[u])
                                - min(op[0] for op in rot[u]))
               for u, (start, end) in enumerate(view.units)]
    return sum(outside) / len(outside) / 1e3
