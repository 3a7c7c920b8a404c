"""Admission control: whether, when, and how hard to re-optimize.

`AdmissionPolicy` is the scheduler's pluggable admission seam. The base
class reproduces the original behavior exactly — head-of-queue FCFS, every
query admitted with the full hook budget — so a scheduler with the base
policy (or none) is bit-identical to the plain async path.

`QoSAdmission` layers the SLO machinery on top, deciding per query:

  whether   a query whose predicted completion blows its deadline by
            more than the ladder's last rung is REJECTED at admission —
            it would only burn lane-seconds pushing other queries past
            their deadlines;
  when      a tenant over its token-bucket rate is DEFERRED to the
            earliest virtual time a token exists (never silently
            dropped: the wait lands in its queueing latency), and
            among eligible queries the pick is earliest-deadline-first,
            with weighted fair share (then stream order) breaking ties —
            so a flooding tenant cannot starve a light one;
  how hard  queries predicted to miss their SLO get a shrunken
            re-optimization hook budget from the `DegradationLadder`
            instead of the agent's full max_steps.

All three decisions compare virtual-clock quantities and consult
deterministic state (token buckets on the virtual clock, a jitted
predictor, seeded training), so the whole control plane is
bit-reproducible: same stream + same seeds => same admissions, same
degradations, same rejections.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.serve.qos.degrade import DegradationLadder, _as_budget
from repro_torch.serve.qos.predictor import LatencyPredictor
from repro_torch.serve.qos.tenancy import TenantRegistry


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str                        # "admit" | "reject" | "defer"
    hook_budget: Optional[int] = None  # None = agent default
    not_before: float = 0.0            # defer: earliest admissible time
    predicted: Optional[float] = None  # predictor's latency estimate
    severity: float = 0.0              # predicted / deadline slack
    degraded: bool = False
    reason: str = ""


_ADMIT = AdmissionDecision("admit")


class AdmissionPolicy:
    """FCFS pass-through: the original semantics as an explicit policy object.
    Subclasses override `select` (which pending query gets the next idle
    lane) and `admit` (admit / defer / reject + hook budget)."""

    def attach(self, scheduler) -> None:
        self._sched = scheduler

    def prepare(self, stream) -> None:
        """Called once per `run()` with the full arrival list, before
        sorting — the hook where deadlines get stamped."""

    def select(self, candidates: List, now: float):
        """Pick the next arrival to place, from the pending queries ahead
        of the next write barrier (stream order preserved by default)."""
        return candidates[0]

    def admit(self, arrival, start_t: float) -> AdmissionDecision:
        return _ADMIT

    def on_complete(self, comp) -> None:
        """Completion feedback (fair-share charging, predictor refresh)."""


class EdfPolicy(AdmissionPolicy):
    """Deadline-only EDF selection (no registry, every query admitted):
    what `LaneScheduler` installs for policy="edf" when no admission
    policy is given, and the single home of the EDF pick."""

    def select(self, candidates: List, now: float):
        # EDF among queries already waiting at `now` — an idle lane never
        # holds for a future arrival (work conserving); with nothing
        # waiting, take the next to arrive
        waiting = [a for a in candidates if max(a.t, a.not_before) <= now]
        if waiting:
            return min(waiting, key=lambda a: (
                a.deadline if a.deadline is not None else math.inf,
                a.t, a.seq))
        return min(candidates, key=lambda a: (max(a.t, a.not_before),
                                              a.seq))


class QoSAdmission(AdmissionPolicy):
    """Learned admission control over a tenant registry: token-bucket
    deferral, EDF + weighted-fair-share selection, predictor-vs-deadline
    rejection, and ladder degradation."""

    def __init__(self, registry: Optional[TenantRegistry] = None, *,
                 predictor: Optional[LatencyPredictor] = None,
                 ladder: Optional[DegradationLadder] = None,
                 reject_hopeless: bool = True, plan_memory=None):
        """`plan_memory` (a `serve.plans.PlanMemory`) enables the ladder's
        memo rungs: at admission the policy peeks (`would_hit`, count-
        free) whether the query's template is memoized on the current
        version band and passes that bit to `ladder.choose` — so a
        severity band that would otherwise reject can admit on the
        replay-the-memoized-plan rung instead."""
        self.registry = registry if registry is not None else TenantRegistry()
        self.predictor = predictor
        # a predictor without a ladder would reject everything it flags or
        # nothing at all — default to the standard 3-rung ladder
        self.ladder = ladder if ladder is not None else DegradationLadder()
        self.reject_hopeless = reject_hopeless
        self.plan_memory = plan_memory
        self.n_admitted = 0
        self.n_degraded = 0
        self.n_rejected = 0
        self.n_deferred = 0            # defer events (retries count once each)
        self.n_memo_admits = 0         # admits earned by a memo rung

    # ------------------------------------------------------------ plumbing
    def attach(self, scheduler) -> None:
        super().attach(scheduler)
        scheduler.on_complete.append(self.on_complete)

    def prepare(self, stream) -> None:
        # a fresh run restarts the virtual clock at its first arrival:
        # token buckets / fair-share must not carry the PREVIOUS stream's
        # end time, or every rate-limited tenant would defer to it
        self.registry.reset_clock()
        for a in stream:
            if a.delta is None:
                a.deadline = self.registry.deadline_for(a.tenant, a.t,
                                                        a.deadline)

    def on_complete(self, comp) -> None:
        self.registry.charge(comp.tenant, comp.service_t)

    # ------------------------------------------------------------ deciding
    def _ready_at(self, a, now: float) -> float:
        t = max(a.t, a.not_before, now)
        return max(t, self.registry.earliest_admit(a.tenant, t))

    def select(self, candidates: List, now: float):
        """EDF within the eligible set: queries already admissible at `now`
        sort by (deadline, fair share, stream order); rate-limited ones
        sort after, by when they become admissible — so a token-starved
        head never blocks another tenant's lane."""
        def key(a):
            ready = self._ready_at(a, now)
            waiting = ready > now
            dl = a.deadline if a.deadline is not None else math.inf
            return (waiting, ready if waiting else 0.0, dl,
                    self.registry.fair_key(a.tenant), a.seq)
        return min(candidates, key=key)

    def admit(self, a, start_t: float) -> AdmissionDecision:
        ready = self._ready_at(a, start_t)
        if ready > start_t + 1e-12:
            self.n_deferred += 1
            return AdmissionDecision("defer", not_before=ready,
                                     reason="rate-limited")
        predicted = None
        if self.predictor is not None and a.deadline is not None:
            predicted = self.predictor.predict_query(a.query)
            slack = a.deadline - start_t
            memo_hit = False
            if self.plan_memory is not None:
                memo_hit = self.plan_memory.would_hit(
                    a.query, self._sched.db.versions)
            d = self.ladder.choose(predicted, slack, memo_hit=memo_hit)
            if d.memo_only:
                self.n_memo_admits += 1
            if d.action == "reject" and self.reject_hopeless:
                self.n_rejected += 1
                return AdmissionDecision(
                    "reject", predicted=predicted, severity=d.severity,
                    reason=f"predicted {predicted:.1f}s vs "
                           f"{slack:.1f}s slack")
            budget = d.hook_budget if d.action == "admit" \
                else _as_budget(self.ladder.rungs[-1].hook_budget)
            self.registry.acquire(a.tenant, start_t)
            self.n_admitted += 1
            self.n_degraded += d.degraded or d.action == "reject"
            return AdmissionDecision(
                "admit", hook_budget=budget, predicted=predicted,
                severity=d.severity,
                degraded=d.degraded or d.action == "reject")
        self.registry.acquire(a.tenant, start_t)
        self.n_admitted += 1
        return AdmissionDecision("admit", predicted=predicted)

    def stats(self):
        return {"admitted": self.n_admitted, "degraded": self.n_degraded,
                "rejected": self.n_rejected, "deferred": self.n_deferred,
                "memo_admits": self.n_memo_admits,
                "tenants": self.registry.stats(),
                "predictor": None if self.predictor is None
                else getattr(self.predictor, "stats", dict)()}
