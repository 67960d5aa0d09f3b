"""The rate and percentile arithmetic of the end-to-end metrics: every
request and all the time of the window, nothing from chunks."""
from __future__ import annotations

import math
from typing import Sequence


def rate(count: float, seconds: float) -> float:
    """All the work of the window over all its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile of all `values`, by the nearest rank: the
    smallest value with at least p % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[rank - 1]

