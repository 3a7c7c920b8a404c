"""Per-query retry ladder with virtual-clock backoff and stage resume.

A failure is the most actionable runtime observation there is, and the
retry ladder treats it the way LQRS treats every other runtime signal —
as input to re-optimization rather than a terminal verdict:

  1. resume   transient/timeout failures keep the failed attempt's
              materialized stage results (`RuntimeState.mats` survives the
              `QueryFailure`), so the retry is seeded with them and the
              remaining plan: it pays only the failed stage onwards on the
              virtual clock. A "crash" loses the lane's in-flight state —
              the retry restarts from scratch (the version-tagged stage
              cache still shortcuts the host-side numpy work).
  2. replan   an OOM is DETERMINISTIC — resuming or blindly re-running the
              same remaining plan hits the same blowup. The retry instead
              re-plans the remainder with fallback hints: broadcast hints
              stripped (a hinted BHJ past `executor_mem` is the one OOM a
              plan can force), and the remaining leaves re-folded greedy
              smallest-first by ACTUAL materialized bytes (estimates only
              where a leaf never materialized), refusing to re-try the
              exact join pair that just blew up when any alternative
              exists — runtime re-optimization applied to failure.
  3. ladder   on the final allowed attempt, an optional original
              `DegradationLadder` + `LatencyPredictor` pair arbitrates:
              if the predicted retry cannot fit the query's remaining
              deadline slack, give up instead of burning a lane.
  4. give up  the failure is emitted as a normal failed Completion
              (tagged with its kind and attempt count).

Backoff is exponential on the virtual clock (`backoff * mult**(attempt-1)`)
and a total `budget_s` of failed-attempt seconds caps how much chaos one
query may absorb. Retries default to hook budget 0 (syntactic + rule-based
AQE, or the resumed/replanned remainder as-is): deterministic, cheap, and
never competing with first-run queries for policy bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.sql.plans import (Leaf, Node, build_left_deep, copy_leaf, leaves)


def _next_join(node):
    """Leftmost-deepest join whose children are both leaves — the stage the
    executor was running when it failed (mirror of AdaptiveRun._drive)."""
    if isinstance(node, Leaf):
        return None
    j = _next_join(node.left)
    if j is not None:
        return j
    j = _next_join(node.right)
    if j is not None:
        return j
    if isinstance(node.left, Leaf) and isinstance(node.right, Leaf):
        return node
    return None


def fallback_plan(state) -> Optional[Node]:
    """Memory-safe replan of a failed run's REMAINING plan (see module
    docstring, rung 2). Returns None when no alternative left-deep fold
    exists — the caller then falls back to a plain restart."""
    plan = state.plan
    if isinstance(plan, Leaf):
        return None
    lvs = [copy_leaf(l) for l in leaves(plan)]
    if len(lvs) < 2:
        return None
    for l in lvs:
        l.broadcast_hint = False
    jn = _next_join(plan)
    banned = None if jn is None else \
        frozenset((jn.left.covered(), jn.right.covered()))
    q = state.query
    # smallest-first by actual materialized bytes where known (alias order
    # breaks ties so the fold is stream-independent)
    rest = sorted(lvs, key=lambda l: (state.leaf_bytes_est(l),
                                      tuple(sorted(l.covered()))))
    order = [rest.pop(0)]
    covered = frozenset(order[0].covered())
    while rest:
        pick = None
        for i, lf in enumerate(rest):
            if not q.conds_between(covered, frozenset(lf.covered())):
                continue
            if (len(order) == 1 and banned is not None
                    and frozenset((order[0].covered(), lf.covered()))
                    == banned):
                continue               # don't re-run the join that blew up
            pick = i
            break
        if pick is None:               # only the banned pair connects: take it
            for i, lf in enumerate(rest):
                if q.conds_between(covered, frozenset(lf.covered())):
                    pick = i
                    break
        if pick is None:
            return None                # disconnected remainder
        lf = rest.pop(pick)
        order.append(lf)
        covered |= lf.covered()
    return build_left_deep(q, order)


@dataclasses.dataclass
class RetryTicket:
    """Rides on a requeued Arrival: everything the next attempt needs."""
    attempt: int = 2                  # attempt number of the NEXT run
    mode: str = "restart"             # "restart" | "resume" | "replan"
    kinds: tuple = ()                 # failure kinds seen so far, in order
    spent_s: float = 0.0              # virtual seconds burned by failures
    plan: Optional[Node] = None       # remaining plan (resume/replan)
    mats: Optional[Dict] = None       # materialized stage results to seed
    stages_done: int = 0
    hook_budget: Optional[int] = 0    # 0 = no policy steps on retries
    first_admit_t: float = 0.0        # attempt 1's lane admission time
    hedge: bool = False               # speculative re-run, not a retry


@dataclasses.dataclass
class RetryDecision:
    ticket: RetryTicket
    delay: float                      # virtual backoff before re-admission


class RetryPolicy:
    """Decides whether/how a failed attempt is re-admitted."""

    def __init__(self, *, max_attempts: int = 3, backoff: float = 0.5,
                 backoff_mult: float = 2.0,
                 budget_s: Optional[float] = None,
                 resume: bool = True, fallback: bool = True,
                 hook_budget: Optional[int] = 0,
                 ladder=None, predictor=None):
        assert max_attempts >= 1
        self.max_attempts = max_attempts
        self.backoff, self.backoff_mult = backoff, backoff_mult
        self.budget_s = budget_s
        self.resume, self.fallback = resume, fallback
        self.hook_budget = hook_budget
        self.ladder, self.predictor = ladder, predictor

    def decide(self, arrival, ticket: Optional[RetryTicket], res, run,
               now: float, admit_t: float) -> Optional[RetryDecision]:
        """None = give up (emit the failure); else the requeue ticket.
        `run` is the failed AdaptiveRun (its .state carries the remaining
        plan and materialized stages); `now` the virtual failure time."""
        prev_attempt = 1 if ticket is None else ticket.attempt
        spent = (0.0 if ticket is None else ticket.spent_s) + res.latency
        first_admit = admit_t if ticket is None else ticket.first_admit_t
        kinds = (() if ticket is None else ticket.kinds) + (res.failure_kind,)
        if prev_attempt >= self.max_attempts:
            return None
        if self.budget_s is not None and spent >= self.budget_s:
            return None
        delay = self.backoff * self.backoff_mult ** (prev_attempt - 1)
        # final-attempt arbitration: hand off to the original degradation
        # ladder — a retry predicted to blow the remaining deadline slack
        # is given up (or degraded), not re-admitted on hope
        hook_budget = self.hook_budget
        if (prev_attempt + 1 == self.max_attempts and self.ladder is not None
                and self.predictor is not None
                and arrival.deadline is not None):
            pred = self.predictor.predict_query(arrival.query)
            slack = arrival.deadline - (now + delay)
            dec = self.ladder.choose(pred, slack)
            if dec.action == "reject":
                return None
            if dec.hook_budget is not None:
                hook_budget = dec.hook_budget

        kind = res.failure_kind
        mode, plan, mats, stages_done = "restart", None, None, 0
        if self.resume and kind != "crash" and run is not None:
            st = run.state
            plan, mats = st.plan, dict(st.mats)
            stages_done = st.stages_done
            mode = "resume"
            if kind == "oom" and not self.fallback:
                # deterministic failure and no replanning allowed: a
                # resume would OOM identically — restart from scratch
                # (exactly what a blind retry would do)
                mode, plan, mats, stages_done = "restart", None, None, 0
            elif kind in ("oom", "timeout") and self.fallback:
                fb = fallback_plan(st)
                if fb is not None:
                    plan, mode = fb, "replan"
                elif kind == "oom":
                    mode, plan, mats = "restart", None, None
                    stages_done = 0
        return RetryDecision(
            RetryTicket(attempt=prev_attempt + 1, mode=mode, kinds=kinds,
                        spent_s=spent, plan=plan, mats=mats,
                        stages_done=stages_done, hook_budget=hook_budget,
                        first_admit_t=first_admit),
            delay)
