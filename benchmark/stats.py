"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all the values (no medians of
    chunks): the smallest value with at least q% of them at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    return work / seconds
