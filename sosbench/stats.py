"""Order statistics the benchmark reports."""
from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile (q in 1..99) of ``values``: linear between
    order statistics, as ``statistics.quantiles(method='inclusive')``."""
    values = sorted(float(v) for v in values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
