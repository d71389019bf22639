"""The benchmark's arithmetic on timings: percentiles and the device's busy
time from intervals."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile of ``values`` (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_length(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """The length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, t in sorted(intervals):
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, t)
    if end < hi:
        out.append((end, hi))
    return out
