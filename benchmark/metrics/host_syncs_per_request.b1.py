"""Calls a request makes on the host that wait for the card: runtime
calls on the main thread named `cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize` or `cudaMemcpy` (not its
`Async` form) that start inside the program's `tfhe.gate` span, over the
traced requests (closed loop). The harness's own copy to the host lies
outside the span."""

import bisect

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy"}


def read(run):
    view = run.trace
    if run.loop != "closed" or view is None or not view.units:
        return None
    gates = view.spans.get("tfhe.gate")
    if gates is None:
        return None
    for start, end in view.units:
        i = bisect.bisect_left(gates.starts, start)
        if i == len(gates.starts) or gates.starts[i] > end:
            return None
    calls = [h for h in view.host
             if h[2] in SYNCS and gates.find(h[0]) is not None]
    return len(calls) / len(view.units)
