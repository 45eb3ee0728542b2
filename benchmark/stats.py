"""Order statistics the metrics and the bound arithmetic share."""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q percent of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(1, math.ceil(q / 100 * len(s))) - 1]


def spread(values) -> float:
    """Interquartile distance over the median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
