"""Order statistics as the benchmark reports them."""

from __future__ import annotations

import math


def percentile(values: list, p: float) -> float:
    """The ``p``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    k = (len(v) - 1) * p / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
