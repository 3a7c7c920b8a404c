"""Deterministic streaming anomaly detectors for the monitor.

Two classic detector shapes, both pure functions of the observation
sequence (value + virtual timestamp) — no wall clock, no RNG — so two
runs of one seeded stream raise byte-identical anomalies:

  EwmaDetector   keeps exponentially-weighted mean/variance of the
                 series; after a warmup of `min_n` observations an
                 observation whose residual exceeds `z` sigmas (in the
                 watched direction) is an anomaly. The anomalous value is
                 NOT folded into the baseline at the alerting step (a
                 spike must not teach the baseline it is normal), but
                 during the post-alert `cooldown` observations folding
                 resumes, so a durable level shift becomes the new
                 normal instead of alerting forever.

  CusumDetector  a one-sided CUSUM over the EWMA-standardized residual:
                 S <- max(0, S + |r| - k) in the watched direction, alert
                 when S > h. Catches slow drifts a per-point z-test never
                 sees; S resets on alert.

Both emit at most one `Anomaly` per `observe` call and respect a
cooldown (in observations) so one incident does not spray alerts at
every completion. `DetectorBank` is the monitor's keyed registry:
detectors are created lazily per metric name from a factory, so
per-tenant series get independent baselines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

__all__ = ["Anomaly", "EwmaDetector", "CusumDetector", "DetectorBank"]


@dataclasses.dataclass(frozen=True)
class Anomaly:
    t: float                  # virtual time of the alerting observation
    metric: str               # series name (filled by the bank)
    kind: str                 # "ewma" | "cusum"
    direction: str            # "high" | "low"
    value: float              # the alerting observation
    baseline: float           # EWMA mean at alert time
    score: float              # z-score (ewma) or CUSUM statistic

    def as_dict(self) -> Dict:
        return {"t": round(self.t, 6), "metric": self.metric,
                "kind": self.kind, "direction": self.direction,
                "value": round(self.value, 6),
                "baseline": round(self.baseline, 6),
                "score": round(self.score, 4)}


class _EwmaBase:
    """Shared EWMA mean/variance state + warmup/cooldown bookkeeping."""

    def __init__(self, *, alpha: float, min_n: int, min_sigma: float,
                 direction: str, cooldown: int):
        assert 0.0 < alpha <= 1.0
        assert direction in ("high", "low", "both"), direction
        self.alpha = alpha
        self.min_n = max(int(min_n), 1)
        self.min_sigma = float(min_sigma)
        self.direction = direction
        self.cooldown = max(int(cooldown), 0)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self._cool = 0
        self.n_alerts = 0

    def _fold(self, x: float) -> None:
        if self.n == 0:
            self.mean, self.var = x, 0.0
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            # EW variance of the residual (West 1979 style, deterministic)
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1

    @property
    def sigma(self) -> float:
        return max(math.sqrt(max(self.var, 0.0)), self.min_sigma)

    def _watched(self, resid: float) -> bool:
        if self.direction == "high":
            return resid > 0
        if self.direction == "low":
            return resid < 0
        return True

    def reset(self) -> None:
        self.mean = self.var = 0.0
        self.n = self._cool = 0


class EwmaDetector(_EwmaBase):
    def __init__(self, *, alpha: float = 0.25, z: float = 4.0,
                 min_n: int = 8, min_sigma: float = 1e-3,
                 direction: str = "high", cooldown: int = 8):
        super().__init__(alpha=alpha, min_n=min_n, min_sigma=min_sigma,
                         direction=direction, cooldown=cooldown)
        self.z = float(z)

    def observe(self, t: float, x: float) -> Optional[Anomaly]:
        x = float(x)
        if self.n < self.min_n:
            self._fold(x)
            return None
        resid = x - self.mean
        score = abs(resid) / self.sigma
        if self._cool > 0:
            self._cool -= 1
            self._fold(x)
            return None
        if self._watched(resid) and score > self.z:
            out = Anomaly(t, "", "ewma",
                          "high" if resid > 0 else "low", x, self.mean,
                          score)
            self._cool = self.cooldown
            self.n_alerts += 1
            return out                  # spike not folded into the baseline
        self._fold(x)
        return None


class CusumDetector(_EwmaBase):
    def __init__(self, *, alpha: float = 0.1, k: float = 0.5,
                 h: float = 5.0, min_n: int = 8, min_sigma: float = 1e-3,
                 direction: str = "high", cooldown: int = 8):
        assert direction in ("high", "low"), "CUSUM is one-sided"
        super().__init__(alpha=alpha, min_n=min_n, min_sigma=min_sigma,
                         direction=direction, cooldown=cooldown)
        self.k, self.h = float(k), float(h)
        self.s = 0.0

    def observe(self, t: float, x: float) -> Optional[Anomaly]:
        x = float(x)
        if self.n < self.min_n:
            self._fold(x)
            return None
        resid = (x - self.mean) / self.sigma
        drift = resid if self.direction == "high" else -resid
        self.s = max(0.0, self.s + drift - self.k)
        baseline = self.mean
        self._fold(x)
        if self._cool > 0:
            self._cool -= 1
            return None
        if self.s > self.h:
            out = Anomaly(t, "", "cusum", self.direction, x, baseline,
                          self.s)
            self.s = 0.0
            self._cool = self.cooldown
            self.n_alerts += 1
            return out
        return None

    def reset(self) -> None:
        super().reset()
        self.s = 0.0


class DetectorBank:
    """Lazily-created detectors keyed by metric name. `factories` maps a
    metric PREFIX (everything before any "[") to a zero-arg detector
    factory; `observe` routes each sample to its metric's detector and
    stamps the metric name onto any anomaly raised."""

    def __init__(self, factories: Dict[str, Callable[[], object]]):
        self.factories = dict(factories)
        self.detectors: Dict[str, object] = {}
        self.anomalies: List[Anomaly] = []

    def _for(self, metric: str):
        det = self.detectors.get(metric)
        if det is None:
            prefix = metric.split("[", 1)[0]
            fac = self.factories.get(prefix)
            if fac is None:
                return None
            det = self.detectors[metric] = fac()
        return det

    def observe(self, metric: str, t: float, x: float) -> Optional[Anomaly]:
        det = self._for(metric)
        if det is None:
            return None
        a = det.observe(t, x)
        if a is not None:
            a = dataclasses.replace(a, metric=metric)
            self.anomalies.append(a)
        return a

    def reset(self) -> None:
        self.detectors.clear()
        self.anomalies.clear()
