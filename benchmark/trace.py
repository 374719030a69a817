"""Reading a torch.profiler Chrome trace of a traced stretch.

Device operations are the trace's kernels, copies and sets. Each is tied
to the host call that launched it (the `correlation` shared by the
runtime call and the device event), and through that call's time to the
spans around it: the harness's `bench.unit` span around each traced
layer or request, and the program's own `tfhe.*` spans
(`tfhe_tpu_torch/instrument.py`), which may nest. Times are microseconds
on the trace's clock, which holds host and device events alike.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + CALL_CATS
UNIT_SPAN = "bench.unit"


class Intervals:
    """The union of the [start, end] spans of one name, as disjoint
    spans found by time: a span nested in or overlapping another of its
    name is merged into it."""

    def __init__(self, spans):
        self.spans = []
        for start, end in sorted(spans):
            if self.spans and start <= self.spans[-1][1]:
                self.spans[-1] = (self.spans[-1][0],
                                  max(self.spans[-1][1], end))
            else:
                self.spans.append((start, end))
        self.starts = [s for s, _ in self.spans]

    def find(self, t: float):
        """Index of the span holding t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return None


class TraceView:
    """The device operations of a traced stretch, tied to the units (gate
    layers or requests) and the layer spans that launched them."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        spans = collections.defaultdict(list)
        main_tid = None
        for e in xs:
            if e.get("cat") == "user_annotation":
                spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
                if e["name"] == UNIT_SPAN:
                    main_tid = e["tid"]
        self.spans = {name: Intervals(v) for name, v in spans.items()}
        calls = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in CALL_CATS
                 and "correlation" in e.get("args", {})}
        self.ops = []  # (start, end, name, launch time or None)
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                launch = calls.get(e.get("args", {}).get("correlation"))
                self.ops.append((e["ts"], e["ts"] + e["dur"], e["name"],
                                 launch))
        self.ops.sort()
        self.host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in xs if e.get("cat") in HOST_CATS
                            and e.get("tid") == main_tid),
                           key=lambda h: (h[0], -h[1]))
        units = self.spans.get(UNIT_SPAN)
        self.units = units.spans if units else []

    @classmethod
    def load(cls, path) -> "TraceView":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def unit_of(self, op):
        """Index of the unit whose span launched `op`, or None."""
        units = self.spans.get(UNIT_SPAN)
        return None if units is None or op[3] is None else units.find(op[3])

    def launched_in(self, name: str) -> list:
        """Device operations launched inside a span of `name`."""
        spans = self.spans.get(name)
        if spans is None:
            return []
        return [op for op in self.ops
                if op[3] is not None and spans.find(op[3]) is not None]

    def by_unit(self, ops) -> dict:
        """`ops` grouped by the unit whose span launched them."""
        out = collections.defaultdict(list)
        for op in ops:
            u = self.unit_of(op)
            if u is not None:
                out[u].append(op)
        return out

    @staticmethod
    def seconds(ops) -> float:
        return sum(end - start for start, end, _, _ in ops) / 1e6

    def window(self):
        """(start, end): from the first unit's start to the later of the
        last unit's end and the end of the last device operation launched
        before it."""
        if not self.units:
            return None
        if not hasattr(self, "_window"):
            last = self.units[-1][1]
            ends = [op[1] for op in self.ops
                    if op[3] is not None and op[3] <= last]
            self._window = (self.units[0][0], max([last] + ends))
        return self._window

    def window_ops(self):
        """Device operations inside the window, clipped to it."""
        win = self.window()
        if win is None:
            return []
        return [(max(s, win[0]), min(e, win[1]), name, launch)
                for s, e, name, launch in self.ops
                if min(e, win[1]) > max(s, win[0])]

    def busy(self) -> list:
        """The union of the window's device operations, as merged
        intervals."""
        merged = []
        for start, end, _, _ in self.window_ops():
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def window_s(self) -> float:
        win = self.window()
        return 0.0 if win is None else (win[1] - win[0]) / 1e6

    def top_ops(self, count: int = 10) -> list:
        """[name, seconds] of the device operations with the most time."""
        total = collections.Counter()
        for start, end, name, _ in self.window_ops():
            total[name] += (end - start) / 1e6
        return [[name, sec] for name, sec in total.most_common(count)]

    def idle_gaps(self, count: int = 10) -> list:
        """[host operation, seconds]: the window's idle time, each gap
        named by the innermost host operation running at its middle."""
        win = self.window()
        if win is None:
            return []
        edges = [win[0]] + [t for iv in self.busy() for t in iv] + [win[1]]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        total = collections.Counter()
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][0] <= mid:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "(no host operation)"
            total[name] += (b - a) / 1e6
        return [[name, sec] for name, sec in total.most_common(count)]
