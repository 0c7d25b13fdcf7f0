"""The arithmetic of the end-to-end metrics: percentiles over requests and
rates over a window."""

from __future__ import annotations

import math

# A request that failed, or is unfinished after the drain, counts as a miss
# beyond every limit: its latency is this many milliseconds.
MISS_MS = 1e9


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default method). Raises on no values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work over the whole window's time."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds

