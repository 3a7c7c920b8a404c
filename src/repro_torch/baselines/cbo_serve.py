"""CBO re-plan serving policy: the classical re-optimizing baseline.

`CboReplanAgent` is a scripted, parameter-free policy with the agent
interface the `LaneScheduler` drives (`meta`/`cfg`/`space`/`act_batch`):
at the pre-execution boundary it picks `cbo(1)` — re-plan the query with
the cost-based optimizer against the CURRENT catalog statistics — and
no-ops at every later boundary. It is what a system that "just re-runs
the optimizer at admission" would do, which makes it the natural probe
for statistics quality: its plans are a deterministic function of
`db.stats`, so serving metrics under this policy isolate the stale-stats
premise from learned-policy effects. `benchmarks/bench_drift.py` uses it
to price re-ANALYZE policies (the drift control plane) against the
paper's never-refresh baseline without an RL confound.

Deterministic and host-cheap by construction: no parameters, no RNG
consumption (keys pass through untouched), one numpy argmax-free branch
per lane.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.actions import ActionSpace
from repro_torch.core.agent import AgentConfig
from repro_torch.core.encoding import WorkloadMeta

__all__ = ["CboReplanAgent"]


class CboReplanAgent:
    def __init__(self, meta: WorkloadMeta,
                 families=("cbo", "lead", "noop"), max_steps: int = 1):
        self.meta = meta
        # Default ONE hook step: the policy only ever acts pre-execution,
        # so a larger budget would just spend scheduler ticks on no-ops.
        # A larger `max_steps` buys mid-run stage boundaries (the extra
        # steps are no-ops), which is what the hedging control plane
        # needs to OBSERVE an overrunning lane before it finishes.
        self.cfg = AgentConfig(max_steps=max_steps, families=tuple(families))
        self.space = ActionSpace(meta.n_tables_max, self.cfg.families)
        self.cbo_idx = 0                      # action 0 == ("cbo", 1)

    def act_batch(self, feat, left, right, mask, amask, keys, *,
                  explore: bool = False):
        """cbo(1) wherever it is legal (the pre-exec boundary), noop
        everywhere else. `explore` is ignored — the baseline is greedy by
        definition — and the PRNG chain passes through untouched."""
        B = amask.shape[0]
        acts = np.where(amask[:, self.cbo_idx] > 0.0, self.cbo_idx,
                        self.space.noop_idx).astype(np.int32)
        return acts, np.zeros(B, np.float32), keys

    def act(self, enc, am, *, explore: bool = False):
        a, lp, _ = self.act_batch(None, None, None, None, am[None],
                                  np.zeros((1, 2), np.uint32))
        return int(a[0]), float(lp[0])
