"""Percentiles and rates, over every sample."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest order statistics (numpy's default)."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    x = (len(s) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (x - lo)


def rate(work: float, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds
