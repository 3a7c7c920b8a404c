"""RecoveryManager: wires the failure-recovery control plane into one
`LaneScheduler` run.

The scheduler owns the virtual clock and the lanes; the manager owns the
recovery POLICY, hooked in at three seams:

  admission   `run_faults` hands each attempt its seeded fault profile
              (fresh dice per attempt); `on_admit` applies stats-corruption
              events to the believed catalog on first-attempt admissions.
  completion  `on_finish` intercepts every finished run BEFORE the
              scheduler emits it. A failed attempt is offered to the
              `RetryPolicy` — on a retry decision the arrival is requeued
              (with its `RetryTicket`: resume state, fallback plan,
              backoff floor) ahead of the next write barrier and the lane
              is freed at the failure time; the Completion is emitted only
              by the FINAL attempt, carrying `attempts`/`recovered`/
              `failure_kind`. Members of a hedge pair are stashed (their
              lane stays HELD — occupied on the virtual clock, invisible
              to admission and write barriers) until both finish, then the
              pair resolves: first virtual finisher wins (a success beats
              an earlier failure), the winner emits as the query's
              completion, and the loser's lane is charged only up to the
              winner's finish — cancellation priced honestly.
  tick        `maybe_hedge` runs after each admission pass: any suspended
              lane whose elapsed virtual seconds exceed `factor x
              predicted` gets a speculative re-run on an idle lane,
              admitted at the boundary where the overrun became
              observable.

Requeued retries keep their original `seq` (one Completion per query, in
stream order) and re-enter the pending queue ahead of the next delta, so
deltas remain STRICT write barriers: everything ahead of a delta in
stream order — including its retries — drains before the delta applies.

With the injector inert and retry/hedge/breaker unset the manager is a
no-op wrapper: every seam returns early and completions are bit-identical
to a scheduler without a recovery plane (pinned by tests/test_recover.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.serve.recover.faults import FaultInjector
from repro_torch.serve.recover.hedge import HedgePolicy
from repro_torch.serve.recover.retry import RetryPolicy, RetryTicket

# hedge attempts draw fault dice from a disjoint attempt namespace: a
# hedge of attempt k is keyed k + 1000, so it re-rolls everything (that is
# the point — a fresh executor) without colliding with retry attempts
_HEDGE_ATTEMPT_BASE = 1000


@dataclasses.dataclass
class RecoveryStats:
    n_failures: int = 0            # failed attempts observed
    n_retries: int = 0             # requeued attempts
    n_resumed: int = 0
    n_replanned: int = 0
    n_restarted: int = 0
    n_given_up: int = 0            # failures emitted after the ladder ended
    n_hedges: int = 0              # speculative runs launched
    n_hedge_wins: int = 0          # the hedge side finished first
    n_hedge_cancelled: int = 0     # loser cancelled before its own finish
    corruptions: int = 0           # stats-corruption events applied
    backoff_s: float = 0.0         # virtual seconds spent backing off
    by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _HedgePair:
    arr: object                    # the query's ORIGINAL arrival
    primary_idx: int
    hedge_idx: int
    primary: Optional[dict] = None   # stash: traj/res/finish_t/admit_t/...
    hedge: Optional[dict] = None


class RecoveryManager:
    def __init__(self, *, injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 hedge: Optional[HedgePolicy] = None,
                 breaker=None):
        self.injector = injector
        self.retry = retry
        self.hedge = hedge
        self.breaker = breaker
        self.sched = None
        self.stats = RecoveryStats()
        self._pairs: Dict[int, tuple] = {}     # lane idx -> (pair, role)
        self._hedged = set()                   # (seq, attempt) already hedged

    # ------------------------------------------------------------ attach
    def attach(self, scheduler) -> None:
        """Reset per-run state and bind to `scheduler` (the scheduler calls
        this from __init__ when constructed with recovery=...)."""
        self.sched = scheduler
        self.stats = RecoveryStats()
        self._pairs = {}
        self._hedged = set()
        if self.breaker is not None:
            self.breaker.attach(scheduler)

    # --------------------------------------------------------- admission
    def run_faults(self, arrival):
        """Fault profile for the attempt this admission starts."""
        if self.injector is None or not self.injector.active:
            return None
        t = arrival.ticket
        attempt = 1 if t is None else t.attempt
        if t is not None and t.hedge:
            attempt += _HEDGE_ATTEMPT_BASE
        return self.injector.run_faults(arrival.seq, attempt)

    def on_admit(self, arrival, admit_t: float) -> None:
        """Stats-corruption events land here (first attempts only): the
        believed nrows of one of the query's tables is scaled — the
        catalog starts lying to every later CBO/policy decision."""
        if self.injector is None or arrival.ticket is not None:
            return
        q = arrival.query
        tables = sorted({r.table for r in q.relations})
        ev = self.injector.admit_corruption(arrival.seq, tables)
        if ev is None:
            return
        seen = set()
        for stats in (self.sched.db.stats, self.sched.est.stats):
            if stats is None or id(stats) in seen:
                continue
            seen.add(id(stats))
            ts = stats.tables.get(ev.table)
            if ts is not None:
                ts.nrows = max(1, int(ts.nrows * ev.factor))
        self.stats.corruptions += 1

    # -------------------------------------------------------- completion
    def on_finish(self, lane, traj, res, finish_t: float) -> bool:
        """True = the manager consumed this finish (requeued or stashed);
        the scheduler must not emit a Completion for it."""
        pr = self._pairs.get(lane.idx)
        if pr is not None:
            pair, role = pr
            stash = {"traj": traj, "res": res, "finish_t": finish_t,
                     "admit_t": lane.admit_t, "lane": lane, "run": lane.run,
                     "hook_budget": lane.hook_budget,
                     "degraded": lane.degraded, "predicted": lane.predicted}
            setattr(pair, role, stash)
            lane.held = finish_t       # stays occupied until the pair resolves
            if pair.primary is not None and pair.hedge is not None:
                self._resolve(pair)
            return True
        if not res.failed:
            return False
        self.stats.n_failures += 1
        self.stats.by_kind[res.failure_kind] = \
            self.stats.by_kind.get(res.failure_kind, 0) + 1
        if self.retry is None:
            return False
        arr = lane.arrival
        dec = self.retry.decide(arr, arr.ticket, res, lane.run, finish_t,
                                lane.admit_t)
        if dec is None:
            self.stats.n_given_up += 1
            return False
        self._requeue(arr, dec, finish_t)
        self.sched._release(lane, finish_t)
        return True

    def _requeue(self, arr, dec, finish_t: float) -> None:
        t = dec.ticket
        obs = getattr(self.sched, "obs", None)
        if obs is not None:
            obs.on_retry(arr.seq, t.attempt, t.mode,
                         t.kinds[-1] if t.kinds else "", finish_t,
                         dec.delay)
        self.stats.n_retries += 1
        field = {"resume": "n_resumed", "replan": "n_replanned",
                 "restart": "n_restarted"}[t.mode]
        setattr(self.stats, field, getattr(self.stats, field) + 1)
        self.stats.backoff_s += dec.delay
        arr.ticket = t
        arr.not_before = max(arr.not_before, finish_t + dec.delay)
        # re-enter the pending queue ahead of the next write barrier,
        # positioned by effective ready time so the backoff never
        # head-of-line-blocks other admissions
        pending = self.sched._pending
        ready = max(arr.t, arr.not_before)
        idx = len(pending)
        for i, a in enumerate(pending):
            if a.delta is not None or max(a.t, a.not_before) > ready:
                idx = i
                break
        pending.insert(idx, arr)

    # ------------------------------------------------------------ hedging
    def maybe_hedge(self) -> None:
        """Called by the run loop after each admission pass: launch hedges
        for overrunning suspended lanes while idle lanes remain."""
        if self.hedge is None:
            return
        sched = self.sched
        idle = [l for l in sched.lanes if l.run is None]
        if not idle:
            return
        for lane in sched.lanes:
            if not idle:
                break
            if lane.run is None or lane.state is None:
                continue               # no run, or held/completed
            if lane.idx in self._pairs:
                continue               # already racing
            arr = lane.arrival
            att = 1 if arr.ticket is None else arr.ticket.attempt
            if (arr.seq, att) in self._hedged:
                continue
            if not self.hedge.should_hedge(lane, self.stats.n_hedges):
                continue
            h = min(idle, key=lambda l: (l.free_at, l.idx))
            idle.remove(h)
            self._hedged.add((arr.seq, att))
            self.stats.n_hedges += 1
            t_b = lane.next_event      # the boundary that revealed the overrun
            admit = max(t_b, h.free_at, sched._write_ts)
            budget = self.hedge.hook_budget if self.hedge.hook_budget \
                is not None else lane.hook_budget
            hedge_ticket = RetryTicket(
                attempt=att, mode="restart", kinds=(),
                spent_s=0.0 if arr.ticket is None else arr.ticket.spent_s,
                plan=None, mats=None, stages_done=0, hook_budget=budget,
                first_admit_t=(lane.admit_t if arr.ticket is None
                               else arr.ticket.first_admit_t),
                hedge=True)            # disjoint fault-dice namespace
            hedge_arr = dataclasses.replace(arr, ticket=hedge_ticket)
            pair = _HedgePair(arr=arr, primary_idx=lane.idx,
                              hedge_idx=h.idx)
            self._pairs[lane.idx] = (pair, "primary")
            self._pairs[h.idx] = (pair, "hedge")
            if getattr(sched, "obs", None) is not None:
                sched.obs.on_hedge_launch(arr.seq, att, lane.idx, h.idx,
                                          admit)
            sched._start(h, hedge_arr, admit,
                         hook_budget=budget, degraded=lane.degraded,
                         predicted=lane.predicted)

    def _resolve(self, pair: _HedgePair) -> None:
        sched = self.sched
        p, h = pair.primary, pair.hedge
        # winner: successes first, then earlier virtual finish, tie->primary
        winner, loser, hedge_won = (p, h, False) \
            if (p["res"].failed, p["finish_t"]) \
            <= (h["res"].failed, h["finish_t"]) else (h, p, True)
        # the loser is cancelled when the winner finishes: its lane is
        # charged min(own finish, winner finish) — never less than what it
        # actually ran, never more than the race took
        loser_free = min(loser["finish_t"], winner["finish_t"])
        if loser_free < loser["finish_t"]:
            self.stats.n_hedge_cancelled += 1
        del self._pairs[pair.primary_idx]
        del self._pairs[pair.hedge_idx]
        sched._release(loser["lane"], loser_free)
        sched._release(winner["lane"], winner["finish_t"])
        if getattr(sched, "obs", None) is not None:
            sched.obs.event("hedge_resolve",
                            {"seq": pair.arr.seq, "hedge_won": hedge_won,
                             "cancelled": loser_free < loser["finish_t"]},
                            t=winner["finish_t"])
        if hedge_won:
            self.stats.n_hedge_wins += 1
        arr = pair.arr
        res = winner["res"]
        if res.failed:
            self.stats.n_failures += 1
            self.stats.by_kind[res.failure_kind] = \
                self.stats.by_kind.get(res.failure_kind, 0) + 1
            if self.retry is not None:
                dec = self.retry.decide(arr, arr.ticket, res, winner["run"],
                                        winner["finish_t"],
                                        winner["admit_t"])
                if dec is not None:
                    self._requeue(arr, dec, winner["finish_t"])
                    return
                self.stats.n_given_up += 1
        first_admit = arr.ticket.first_admit_t if arr.ticket is not None \
            else min(p["admit_t"], h["admit_t"])
        comp = sched._build_comp(
            arr, winner["traj"], res, winner["admit_t"], winner["finish_t"],
            winner["lane"].idx, winner["hook_budget"], winner["degraded"],
            winner["predicted"], hedged=True, first_admit=first_admit)
        sched._emit(comp)
