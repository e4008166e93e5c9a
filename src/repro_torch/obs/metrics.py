"""Lightweight serving metrics: counters, gauges, streaming histograms (port
of ``repro.obs.metrics``, pure Python as there).

The registry is the host-side half of serving observability: every value it
holds is recorded at an existing host synchronization point (burst boundary,
prefill return, speculative-round commit), so attaching it to a server never
adds a device round-trip and never changes a captured program.

Histograms are streaming: observations land in geometric buckets
(``growth``-spaced), so memory stays bounded at O(log(range)) while count,
sum, min, and max remain exact. Quantiles (p50/p90/p99) are read from the
bucket boundaries — the error is bounded by one bucket width (< ``growth``
relative), which is far below scheduling noise for latency telemetry.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["Counter", "Gauge", "StreamingHistogram", "MetricsRegistry"]


class Counter:
    """A monotonically-increasing count (requests, tokens, transfers...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A last-write-wins scalar (run tok/s, acceptance rate...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class StreamingHistogram:
    """Geometric-bucket histogram with exact count/sum/min/max.

    Bucket ``i`` covers ``(floor * growth**(i-1), floor * growth**i]``;
    values at or below ``floor`` share bucket 0. One dict entry per occupied
    bucket — O(1) per observation, bounded memory, mergeable.
    """

    __slots__ = ("growth", "floor", "count", "total", "lo", "hi", "_buckets",
                 "_log_growth")

    def __init__(self, growth: float = 1.25, floor: float = 1e-7) -> None:
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.growth = growth
        self.floor = floor
        self._log_growth = math.log(growth)
        self.count = 0
        self.total = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self._buckets: Dict[int, int] = {}

    def _index(self, v: float) -> int:
        if v <= self.floor:
            return 0
        return max(0, math.ceil(math.log(v / self.floor) / self._log_growth))

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``n`` observations of value ``v`` (``n > 1`` spreads one
        measured aggregate, e.g. a burst's per-token latency)."""
        v = float(v)
        self.count += n
        self.total += v * n
        self.lo = min(self.lo, v)
        self.hi = max(self.hi, v)
        i = self._index(v)
        self._buckets[i] = self._buckets.get(i, 0) + n

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (0..1) from bucket boundaries, clamped to the exact
        observed [min, max]. None when empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if seen >= rank:
                # geometric bucket midpoint; exact bounds clamp the tails
                mid = self.floor * self.growth ** max(i - 0.5, 0.0)
                return min(max(mid, self.lo), self.hi)
        return self.hi

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> Dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.lo,
            "max": self.hi,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named counters / gauges / histograms with a JSON-able snapshot."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, StreamingHistogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> StreamingHistogram:
        return self.histograms.setdefault(name, StreamingHistogram())

    # conveniences for hook-site brevity
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float, n: int = 1) -> None:
        self.histogram(name).observe(v, n)

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()

    def snapshot(self) -> Dict:
        """One JSON-able dict: {"counters": ..., "gauges": ..., "histograms":
        {name: {count, mean, min, max, p50, p90, p99}}}."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self.histograms.items())
            },
        }
