"""Coverage-driven probe sets for the policy-store gate.

The original `PolicyStore` shadow-evaluates every candidate policy on a FIXED
held-out probe list. After drift that list measures the wrong thing: a
candidate can look "no worse" on probes whose tables never moved while
regressing badly on the drifted ones (exactly the queries the lifelong
loop is trying to unlearn). `CoverageProbeSet` keeps a larger held-out
POOL and re-samples the k gate probes whenever the detector reports
drift, weighting each pool query by the drift scores of the tables it
touches:

    w(q) = base_weight + Σ_{t ∈ tables(q)} score(t)

Sampling is weighted-without-replacement from an OWN seeded generator, so
a fixed seed makes every resample (and therefore every gate verdict
downstream) bit-reproducible. With zero drift everywhere the weights are
uniform and the set is an unbiased draw from the pool — the fixed-list
behavior, modulo which k queries represent it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serve.drift.detector import TableDrift

__all__ = ["CoverageProbeSet"]


class CoverageProbeSet:
    def __init__(self, pool: Sequence, *, k: int = 4,
                 base_weight: float = 0.25, seed: int = 0):
        assert pool, "probe pool must not be empty"
        assert base_weight > 0.0, "zero base weight starves undrifted " \
            "templates of any gate coverage"
        self.pool = list(pool)
        self.k = min(k, len(self.pool))
        self.base_weight = base_weight
        self._rng = np.random.default_rng(seed)
        self._tables = [tuple(sorted({r.table for r in q.relations}))
                        for q in self.pool]
        self.n_resamples = 0

    def weights(self, drifts: Dict[str, TableDrift]) -> np.ndarray:
        w = np.full(len(self.pool), self.base_weight, np.float64)
        for i, tabs in enumerate(self._tables):
            w[i] += sum(drifts[t].score for t in tabs if t in drifts)
        return w

    def resample(self, drifts: Dict[str, TableDrift]) -> List:
        """Draw the next k-probe gate set, biased toward drifted tables.
        Returned in pool order so the gate replays probes in a stable
        order regardless of draw order."""
        w = self.weights(drifts)
        idx = self._rng.choice(len(self.pool), size=self.k, replace=False,
                               p=w / w.sum())
        self.n_resamples += 1
        return [self.pool[i] for i in sorted(idx)]

    def stats(self) -> Dict[str, float]:
        return {"pool": len(self.pool), "k": self.k,
                "resamples": self.n_resamples}
