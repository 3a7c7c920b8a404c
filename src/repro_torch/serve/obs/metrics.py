"""Deterministic metrics registry for the serving plane.

Three instrument kinds, all pure host-side state driven from virtual-clock
observation points (never from wall time), so two runs of the same seeded
stream produce byte-identical metric state:

  Counter     monotone int (completions, retries, control-plane events);
  Gauge       last-written value OR a pull callback evaluated at sample
              time (lane occupancy, queue depth, cache bytes — the
              callback reads live scheduler state);
  Histogram   FIXED bucket bounds chosen at creation: observations land
              in the first bucket whose upper bound is >= value (last
              bucket is +inf). No adaptive resizing, no quantile sketches
              — determinism over fidelity.

Sampling. `advance(t)` is called by the tracer at its observation points
(scheduler ticks, completions, deltas) with the current virtual time;
whenever `t` crosses one or more `interval` boundaries since the last
sample, ONE row — counters + gauges evaluated now, stamped at the last
crossed boundary — is appended to `self.series`. At most one row per
observation point: a 300s straggler gap yields one row, not 300, keeping
the series bounded by the number of events while still being a pure
function of the event sequence. The series is the logged per-tenant /
per-resource time series the ROADMAP's forecast-driven autoscaling item
needs to forecast from.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BOUNDS", "MARGIN_BOUNDS"]

# fixed bucket menus (virtual seconds)
LATENCY_BOUNDS = (0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
MARGIN_BOUNDS = (-300.0, -60.0, -10.0, -1.0, 0.0, 1.0, 10.0, 60.0, 300.0)


@dataclasses.dataclass
class Counter:
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Set-style or pull-style: a callback wins over the stored value."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self.fn = fn
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class Histogram:
    """Fixed-bucket histogram: counts[i] = observations with
    value <= bounds[i] (and counts[-1] the +inf overflow bucket)."""

    def __init__(self, bounds: Sequence[float]):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        assert list(self.bounds) == sorted(set(self.bounds)), \
            "histogram bounds must be strictly increasing"
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.n += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def as_dict(self) -> Dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "n": self.n, "sum": round(self.total, 6)}


class MetricsRegistry:
    def __init__(self, interval: float = 5.0):
        assert interval > 0.0
        self.interval = float(interval)
        self.series: List[Dict] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._next: Optional[float] = None     # next sample boundary

    # ------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(fn)
        elif fn is not None:
            g.fn = fn                           # rebind pull source
        return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = LATENCY_BOUNDS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(bounds)
        return h

    # ---------------------------------------------------------- sampling
    def advance(self, t: float) -> None:
        """Observe virtual time `t`; emit one sample row if one or more
        interval boundaries were crossed since the last row."""
        t = float(t)
        if self._next is None:
            # first observation anchors the grid at the NEXT boundary
            self._next = (math.floor(t / self.interval) + 1) * self.interval
            return
        if t < self._next:
            return
        # stamp at the last boundary <= t (one row per observation point)
        stamp = math.floor(t / self.interval) * self.interval
        self.series.append(self._row(stamp))
        self._next = stamp + self.interval

    def _row(self, t: float) -> Dict:
        row: Dict = {"t": round(t, 6)}
        for name, c in self._counters.items():
            row[name] = c.value
        for name, g in self._gauges.items():
            row[name] = round(g.read(), 6)
        return row

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        """Full registry state (counters, gauge reads, histograms) — the
        deterministic blob benchmarks persist."""
        return {
            "interval": self.interval,
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: round(g.read(), 6)
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self._hists.items())},
            "n_samples": len(self.series),
        }

    def reset(self) -> None:
        """Drop all instrument state and the sampled series (gauge pull
        callbacks are kept: they are wiring, not measurement)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = 0.0
        self._hists.clear()
        self.series.clear()
        self._next = None
