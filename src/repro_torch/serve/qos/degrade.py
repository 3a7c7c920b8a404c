"""Degradation ladder: "how much re-optimization" as a runtime decision.

LQRS's thesis is that optimization decisions belong at execution time;
the ladder pushes that one level up: the amount of learned
re-optimization a query receives is itself decided at admission, from
the ratio of its predicted latency to its remaining deadline slack
(severity = predicted / slack).

  severity <= 1      on track: full hook budget (the agent's max_steps).
  1 < s <= mild      predicted to miss but close: shrink the hook budget
                     (fewer act_batch boundaries) — the query still gets
                     a cheap shot at re-optimization without consuming
                     full policy bandwidth it can't convert into an
                     on-time finish.
  mild < s <= hard   hopeless-ish: budget 0 — the syntactic plan + rule-
                     based AQE runs as-is (the original cold path), and the
                     saved act_batch slots go to queries still inside
                     their deadlines.
  s > hard           hopeless: reject at admission (when the admission
                     policy allows) — burning lane-seconds on a
                     guaranteed miss only pushes OTHER queries past
                     their deadlines.

A rung's budget may also be the sentinel `"memo"`: replay-a-memoized-plan
— cheaper than ANY hook budget (a plan-memory hit runs zero act_batch
calls AND reuses a proven plan, where budget 0 runs the raw syntactic
plan). A memo rung only matches when the admission policy reports the
query would hit the plan memory (`choose(..., memo_hit=True)`); without
a hit it is skipped and severity falls through to the next rung /
reject, so ladders stay well-defined with no memory attached.

`choose` is a pure function of virtual-clock quantities (predicted
seconds vs deadline slack) plus the deterministic memo-hit bit, so
ladder decisions are bit-reproducible; the admission policy owns the
counters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

MEMO = "memo"                         # rung sentinel: replay memoized plan


def _as_budget(b) -> Optional[int]:
    """Collapse a rung budget to the int the scheduler consumes: a memo
    rung admits with budget 0 (the memory probe, not the budget, scripts
    the replay — and on a fence race 0 is the cheapest safe fallback)."""
    return 0 if b == MEMO else b


@dataclasses.dataclass(frozen=True)
class Rung:
    max_severity: float               # rung applies while severity <= this
    hook_budget: object               # None = agent default (full budget),
    #                                   int = shrunken, "memo" = replay


@dataclasses.dataclass(frozen=True)
class DegradeDecision:
    action: str                       # "admit" | "reject"
    hook_budget: Optional[int]        # None = full budget
    severity: float
    degraded: bool                    # True when the budget was shrunk
    memo_only: bool = False           # admitted on the memo rung


class DegradationLadder:
    """Maps (predicted latency, deadline slack) -> hook budget / reject."""

    def __init__(self, rungs: Sequence[Tuple[float, Optional[int]]] = (
            (1.0, None), (2.0, 1), (4.0, 0)),
            reject_above: Optional[float] = 4.0):
        assert rungs, "ladder needs at least one rung"
        self.rungs = tuple(Rung(float(c), b) for c, b in rungs)
        assert all(a.max_severity < b.max_severity for a, b in
                   zip(self.rungs, self.rungs[1:])), \
            "rung ceilings must increase"
        assert reject_above is None or \
            reject_above >= self.rungs[-1].max_severity, \
            "reject_above below the last rung ceiling would never fire " \
            "(rungs match first)"
        self.reject_above = reject_above

    @classmethod
    def with_memo_rung(cls) -> "DegradationLadder":
        """The standard ladder plus a memoized-replay rung below reject:
        severity in (4, 8] queries that would previously be rejected (or
        caught at budget 0) instead replay their template's best-known
        plan when the memory has one — zero policy cost, proven plan."""
        return cls(rungs=((1.0, None), (2.0, 1), (4.0, 0), (8.0, MEMO)),
                   reject_above=8.0)

    def choose(self, predicted: float, slack: float,
               memo_hit: bool = False) -> DegradeDecision:
        """Pick the rung for a query predicted to take `predicted` virtual
        seconds with `slack` seconds left until its deadline. `memo_hit`
        gates memo rungs: True iff the plan memory would serve this query
        (the admission policy probes `PlanMemory.would_hit`)."""
        severity = predicted / slack if slack > 0.0 else float("inf")
        for rung in self.rungs:
            if rung.hook_budget == MEMO and not memo_hit:
                continue              # no memoized plan: fall through
            if severity <= rung.max_severity:
                if rung.hook_budget == MEMO:
                    return DegradeDecision("admit", 0, severity, True,
                                           memo_only=True)
                return DegradeDecision("admit", rung.hook_budget, severity,
                                       rung.hook_budget is not None)
        if self.reject_above is not None and severity > self.reject_above:
            return DegradeDecision("reject", None, severity, False)
        # no reject rung: the cheapest budget catches everything above
        return DegradeDecision("admit", _as_budget(self.rungs[-1].hook_budget),
                               severity, True)
