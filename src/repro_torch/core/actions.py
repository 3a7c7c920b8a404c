"""Action space (Tab. I), masking (§V-B3) and curriculum schedule.

Layout over a workload with at most n tables (d = 2 + (n-1) + C(n,2) + n + 1):

  [cbo(1), cbo(0)] ++ [lead(2..n)] ++ [swap(i,j) for i<j lexicographic]
                   ++ [broadcast(1..n)] ++ [no-op]

AQORA's *default* action space enables the cbo / lead / no-op families
(§VII-D: swap is subsumed by lead in practice; broadcast destabilizes
training by broadcasting oversized tables) — the other families exist for
the action-space ablation and are masked out by configuration, exactly how
the paper reports it.

Curriculum (§V-B3): stage 1 exposes only cbo(0/1)+no-op; stage 2 lifts the
mask on runtime plan adjustments (lead/swap once true cardinalities exist,
i.e. after the first stage completes); stage 3 removes every restriction
except invalid-action masking. Offline training walks the stages at fixed
episode fractions (`curriculum_stage`); the serving-time loop promotes on
live rolling stats instead (`learn.curriculum.AdaptiveCurriculum`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.sql import cbo as cbo_mod
from repro_torch.sql.executor import RuntimeState, planned_shuffles
from repro_torch.sql.plans import (apply_broadcast, apply_lead, apply_swap,
                             leaves, syntactic_plan)


@dataclasses.dataclass(frozen=True)
class ActionSpace:
    n: int                                  # max tables in the workload
    families: Tuple[str, ...] = ("cbo", "lead", "noop")

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        return list(itertools.combinations(range(1, self.n + 1), 2))

    @property
    def d(self) -> int:
        n = self.n
        return 2 + (n - 1) + n * (n - 1) // 2 + n + 1

    # ---- index blocks
    @property
    def lead_off(self) -> int:
        return 2

    @property
    def swap_off(self) -> int:
        return 2 + (self.n - 1)

    @property
    def bcast_off(self) -> int:
        return self.swap_off + self.n * (self.n - 1) // 2

    @property
    def noop_idx(self) -> int:
        return self.d - 1

    def decode(self, idx: int):
        if idx == 0:
            return ("cbo", 1)
        if idx == 1:
            return ("cbo", 0)
        if idx < self.swap_off:
            return ("lead", idx - self.lead_off + 2)       # lead(2..n)
        if idx < self.bcast_off:
            i, j = self.pairs[idx - self.swap_off]
            return ("swap", i, j)
        if idx < self.noop_idx:
            return ("broadcast", idx - self.bcast_off + 1)
        return ("noop",)


def curriculum_stage(episode: int, total: int,
                     fractions=(0.25, 0.55)) -> int:
    f = episode / max(total, 1)
    if f < fractions[0]:
        return 1
    if f < fractions[1]:
        return 2
    return 3


def action_mask(space: ActionSpace, state: RuntimeState, stage: int = 3,
                query=None) -> np.ndarray:
    """Legality x curriculum x configured-families mask."""
    query = query or state.query
    m = np.zeros(space.d, np.float32)
    m[space.noop_idx] = 1.0
    fams = set(space.families)
    lvs = leaves(state.plan)
    n_l = len(lvs)
    pre_exec = state.stages_done == 0 and state.step == 0
    runtime_ok = stage >= 3 or (stage >= 2 and state.stages_done >= 1)

    if "cbo" in fams and pre_exec and stage >= 1:
        m[0] = 1.0
        m[1] = 1.0
    if "lead" in fams and runtime_ok:
        for i in range(2, min(n_l, space.n) + 1):
            if apply_lead(query, state.plan, i) is not None:
                m[space.lead_off + i - 2] = 1.0
    if "swap" in fams and runtime_ok:
        for k, (i, j) in enumerate(space.pairs):
            if j <= n_l and apply_swap(query, state.plan, i, j) is not None:
                m[space.swap_off + k] = 1.0
    if "broadcast" in fams and runtime_ok:
        for i in range(1, min(n_l, space.n) + 1):
            if not lvs[i - 1].broadcast_hint:
                m[space.bcast_off + i - 1] = 1.0
    return m


def apply_action(space: ActionSpace, state: RuntimeState, idx: int):
    """Returns (new_plan_or_None, shaping_reward, extra_plan_seconds).

    r = -(Δ planned shuffles)/10 (§V-A1c): no-op never adds shuffles, so it
    earns 0; actions that add shuffles are penalized immediately.
    """
    act = space.decode(idx)
    if act[0] == "noop":               # no plan change, no Δshuffles walk
        return None, 0.0, 0.0
    before = planned_shuffles(state.plan, state)
    extra_plan = 0.0
    if act[0] == "cbo":
        if act[1] == 1:
            plan, t = cbo_mod.cbo_plan(state.query, state.est)
            extra_plan = t
        else:
            plan = syntactic_plan(state.query)
    elif act[0] == "lead":
        plan = apply_lead(state.query, state.plan, act[1])
    elif act[0] == "swap":
        plan = apply_swap(state.query, state.plan, act[1], act[2])
    elif act[0] == "broadcast":
        plan = apply_broadcast(state.plan, act[1])
    else:
        raise ValueError(act)
    if plan is None:
        return None, 0.0, extra_plan
    after = planned_shuffles(plan, state)
    return plan, -(after - before) / 10.0, extra_plan
