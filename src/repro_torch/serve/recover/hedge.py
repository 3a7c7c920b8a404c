"""Speculative execution (hedged requests) on the virtual clock.

When a suspended run's elapsed virtual seconds already exceed
`factor x` its predicted latency and an idle lane exists, the scheduler
launches a HEDGE: a fresh attempt of the same query, admitted on the idle
lane at the stage boundary where the overrun became observable. The two
attempts race; the first virtual finisher wins (a success beats an
earlier failure) and the loser is cancelled — its lane is charged until
the winner's finish and not a second longer, the honest virtual-clock
analogue of killing a speculative task.

Why it works under the fault model: straggler ("slow") faults are drawn
per ATTEMPT — a hedge rolls new dice, so a run stuck behind a 8-32x lane
multiplier is rescued by a healthy re-run at the cost of one idle lane.
Deterministic failures (a plan that OOMs) are NOT rescued — both
attempts hit them, which is the retry ladder's job, not the hedge's.

Predictions come from the admission-time estimate when one exists
(`Completion.predicted`, the original `LatencyPredictor` path) and otherwise
from this policy's own `predictor` (anything with
`predict_query(q) -> seconds | None`). No prediction = no hedge.
"""
from __future__ import annotations

from typing import Optional


class HedgePolicy:
    def __init__(self, *, factor: float = 3.0, predictor=None,
                 min_predicted: float = 0.0, hook_budget: Optional[int] = None,
                 max_hedges: Optional[int] = None):
        """`factor`: overrun multiple that triggers a hedge. `min_predicted`
        filters sub-second queries not worth a lane. `hook_budget`: policy
        steps for the hedge run (None = same as the primary). `max_hedges`
        caps speculative launches per scheduler run."""
        assert factor > 1.0
        self.factor = factor
        self.predictor = predictor
        self.min_predicted = min_predicted
        self.hook_budget = hook_budget
        self.max_hedges = max_hedges

    def predicted(self, lane) -> Optional[float]:
        if lane.predicted is not None:
            return lane.predicted
        if self.predictor is not None:
            return self.predictor.predict_query(lane.arrival.query)
        return None

    def should_hedge(self, lane, n_launched: int) -> bool:
        """Overrun test for one suspended lane (idleness and pair state are
        the manager's job)."""
        if self.max_hedges is not None and n_launched >= self.max_hedges:
            return False
        pred = self.predicted(lane)
        if pred is None or pred < self.min_predicted:
            return False
        return lane.state.elapsed >= self.factor * pred
