"""Log-bucketed latency histograms: percentiles without raw samples.

A serving run at production depth emits millions of per-call latencies;
storing them to compute p99 at shutdown is exactly the kind of
unbounded-memory observability the engine must not carry. ``LogHistogram``
keeps a fixed-granularity geometric bucketing instead: bucket ``i``
covers ``[min_value * growth**i, min_value * growth**(i+1))``, so
relative resolution is constant (``growth - 1``, ~9% at the default
1.09) across nine-plus decades while memory stays O(occupied buckets).

Percentiles are nearest-rank over the bucket counts and report the
GEOMETRIC MIDPOINT of the selected bucket — the estimate's relative
error is bounded by half a bucket width. Port of
``repro.obs.histogram`` (recording, percentiles and the JSON round trip
``metrics.state_dict`` carries; merging comes with the snapshot slice).
"""

from __future__ import annotations

import math
from typing import Dict


class LogHistogram:
    """Fixed-shape log-bucketed histogram of non-negative samples."""

    def __init__(self, min_value: float = 1e-6, growth: float = 1.09):
        if not min_value > 0 or not growth > 1:
            raise ValueError("need min_value > 0 and growth > 1")
        self.min_value = min_value
        self.growth = growth
        self._log_g = math.log(growth)
        self.buckets: Dict[int, int] = {}    # bucket index -> count
        self.count = 0
        self.total = 0.0

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        return int(math.log(value / self.min_value) // self._log_g)

    def add(self, value: float):
        """Record one sample (values <= min_value land in bucket 0)."""
        if value < 0:
            raise ValueError(f"negative sample {value}")
        i = self._index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.total += value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile estimate (geometric bucket midpoint).
        0.0 when empty — percentiles of nothing are a reporting edge,
        not an error."""
        if not self.count:
            return 0.0
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                lo = self.min_value * self.growth ** i
                return lo * math.sqrt(self.growth)
        raise AssertionError("rank beyond total count")  # unreachable

    def summary_ms(self) -> dict:
        """The reporting block metrics.summary() embeds per call kind:
        count + mean/p50/p95/p99 in MILLISECONDS (samples are seconds)."""
        return {
            "count": self.count,
            "mean_ms": 1e3 * self.mean,
            "p50_ms": 1e3 * self.percentile(0.50),
            "p95_ms": 1e3 * self.percentile(0.95),
            "p99_ms": 1e3 * self.percentile(0.99),
        }

    def to_dict(self) -> dict:
        """JSON-safe snapshot (bucket keys stringified for JSONL)."""
        return {"min_value": self.min_value, "growth": self.growth,
                "count": self.count, "total": self.total,
                "buckets": {str(i): n for i, n in
                            sorted(self.buckets.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(min_value=d["min_value"], growth=d["growth"])
        h.count = int(d["count"])
        h.total = float(d["total"])
        h.buckets = {int(i): int(n) for i, n in d["buckets"].items()}
        return h
