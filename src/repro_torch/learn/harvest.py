"""Serve-time trajectory harvesting.

`TrajectoryHarvester` is the opt-in bridge between the scheduler's
completion stream and the replay buffer: attached to a `LaneScheduler`
(directly or via `QueryService(hooks=[...])`), it turns every Completion
into a tagged `replay.Experience` — recording the per-stage
observations/actions/rewards the serving path already computed, plus the
live per-table data versions at finish time. Harvesting is pure
bookkeeping on data the scheduler produced anyway, so it adds no policy
calls and no virtual-clock cost.

Trajectories with zero decision points (queries that ran to completion
before the first stage boundary) carry no gradient and are counted but
not buffered.

Plan-memory interplay: MEMOIZED completions (`comp.memoized`) replayed a
scripted action sequence — no policy evaluation happened, their logps
are 0.0 placeholders, and feeding them to PPO would poison the
importance ratios — so they are counted (`n_memoized`) and skipped. For
NON-memoized completions, when a `plan_memory` is wired in, the observed
latency is folded back into the matching entry's streaming stats
(`PlanMemory.note_latency`): the memory's mean/variance per template
keeps tracking live serving conditions even while the entry itself is
not being replayed.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.learn.replay import Experience, ReplayBuffer


class TrajectoryHarvester:
    def __init__(self, replay: Optional[ReplayBuffer] = None,
                 plan_memory=None):
        self.replay = replay if replay is not None else ReplayBuffer()
        self.plan_memory = plan_memory
        self.n_seen = 0
        self.n_harvested = 0
        self.n_empty = 0
        self.n_retried = 0
        self.n_memoized = 0
        self.n_fed_back = 0            # latencies folded into memory stats
        self._sched = None

    def attach(self, scheduler) -> None:
        self._sched = scheduler
        scheduler.on_complete.append(self._on_complete)

    # ------------------------------------------------------------ harvest
    def _on_complete(self, comp) -> None:
        self.n_seen += 1
        if getattr(comp, "memoized", False):
            # scripted replay: logps are placeholders, not policy samples
            self.n_memoized += 1
            return
        if self.plan_memory is not None and not comp.result.failed:
            if self.plan_memory.note_latency(
                    comp.query, self._sched.db.versions,
                    comp.result.latency):
                self.n_fed_back += 1
        if not comp.traj.actions:
            self.n_empty += 1
            return
        tables = tuple(sorted({r.table for r in comp.query.relations}))
        versions = {t: self._sched.db.table_version(t) for t in tables}
        self.replay.add(Experience(
            seq=comp.seq, query_name=comp.query.name, traj=comp.traj,
            latency=comp.result.latency, failed=comp.result.failed,
            finish_t=comp.finish_t, tables=tables, versions=versions,
            # recovery tags: the scheduler emits one Completion per query
            # (the final attempt), so replay sees retried queries once —
            # tagged, not duplicated; completion-like objects without the
            # recovery fields read as single untried attempts
            attempts=getattr(comp, "attempts", 1),
            recovered=getattr(comp, "recovered", False),
            hedged=getattr(comp, "hedged", False)))
        self.n_harvested += 1
        if getattr(comp, "attempts", 1) > 1:
            self.n_retried += 1

    def stats(self) -> Dict[str, float]:
        return {"seen": self.n_seen, "harvested": self.n_harvested,
                "empty": self.n_empty, "retried": self.n_retried,
                "memoized": self.n_memoized, "fed_back": self.n_fed_back,
                **self.replay.stats()}
