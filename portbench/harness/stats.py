"""Order statistics of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, p: float):
    """Nearest-rank p-th percentile (the smallest value with at least p%
    of the sample at or below it); None for an empty sample."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]
