"""Plan memory + background superoptimization (the serving fast path).

`PlanMemory` memoizes the best-known re-optimization action sequence per
(template signature x table-version band); a scheduler probe hit replays
it through `AdaptiveRun` with zero `act_batch` calls. `Superoptimizer`
spends idle completion cadence on deterministic beam search over hot
templates, promoting candidates that beat the incumbent's modeled cost.
Drift fences entries (demotes them to hint priors) instead of deleting.
"""
from repro_torch.serve.plans.memory import (PlanEntry, PlanMemory, band_for,
                                      template_signature)
from repro_torch.serve.plans.superopt import Superoptimizer, SuperoptStats

__all__ = ["PlanEntry", "PlanMemory", "Superoptimizer", "SuperoptStats",
           "band_for", "template_signature"]
