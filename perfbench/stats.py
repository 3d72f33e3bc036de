"""The end-to-end metrics' arithmetic and the spread that sets their bounds."""

from __future__ import annotations

import statistics
from typing import List, Sequence


def rate(examples: int, seconds: float) -> float:
    """Examples a second over the whole window."""
    return examples / seconds


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    sorted values' closest ranks."""
    s = sorted(xs)
    if not s:
        raise ValueError("no values")
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def intervals(stamps: Sequence[float]) -> List[float]:
    """The times between consecutive stamps."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles, as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
