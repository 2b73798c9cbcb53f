"""Window arithmetic: rates over the whole window and percentiles over all
requests in it."""
from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """The p-th percentile (0..100) of all `values`, interpolated linearly
    between the two nearest ranks (numpy's default). None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Events per second over the whole window."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return count / seconds


def slices(times, t0: float, t1: float, width: float) -> list[int]:
    """How many of `times` fall in each `width` seconds from t0 to t1 (the
    last slice may be shorter)."""
    n = max(1, math.ceil((t1 - t0) / width))
    out = [0] * n
    for t in times:
        if t0 <= t <= t1:
            out[min(int((t - t0) / width), n - 1)] += 1
    return out
