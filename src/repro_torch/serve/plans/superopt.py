"""Background superoptimizer: offline cycles spent on hot templates.

Rides the scheduler's completion hook exactly like `learn.BackgroundLearner`
— "background" means interleaved with serving ticks on the virtual clock,
not a thread: every `opt_every`-th completion it sweeps the hottest
not-yet-optimized (template x band) keys — hottest first, as many as the
round's `sim_budget` covers — running a deterministic beam search over
action sequences per key, simulating each candidate prefix through a
private resumable `AdaptiveRun` on the LIVE database
(`reuse_stages=False`, so simulations never warm the serving cache or
touch the virtual clock; all search cost is measured host seconds).

It also rides the delta barrier: when a delta moves templates onto a new
table-version band (the same moment `PlanMemory` fences their entries),
the superoptimizer re-keys their heat onto the new band and runs an
immediate round at the barrier's apply time — so re-promotion lands
BEFORE the first post-drift arrival probes the memory, instead of
lagging a completion cadence behind while stale-fenced templates fall
back to the agent.

Heat comes from the original plan-provenance ledger (`obs.monitor.PlanLedger`)
when one is provided — the same (template, band) latency stats the RCA
engine reads — and from the superoptimizer's own completion counts
otherwise. The beam is seeded with the incumbent memory entry and with
any FENCED prior (a stale best sequence is a hint, not garbage), expands
only mask-legal non-noop actions in sorted order under a hard `sim_budget`
per round, and PROMOTES into `PlanMemory` only when the best candidate's
modeled cost strictly beats the re-simulated incumbent's (by `margin`)
— so a promotion can never regress what serving already replays, and
the whole search is a pure function of (database state, seed-free
deterministic expansion order): two runs of one stream promote
identical sequences (pinned by tests/test_planmem.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.actions import action_mask, apply_action
from repro_torch.serve.plans.memory import band_for, template_signature
from repro_torch.sql.executor import AdaptiveRun
from repro_torch.sql.plans import syntactic_plan

__all__ = ["Superoptimizer", "SuperoptStats"]

_INF = float("inf")


@dataclasses.dataclass
class SuperoptStats:
    completions: int = 0
    rounds: int = 0                    # beam searches run
    sims: int = 0                      # candidate simulations executed
    promotions: int = 0
    skipped_no_gain: int = 0           # rounds whose best lost to incumbent
    host_seconds: float = 0.0

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["host_seconds"] = round(d["host_seconds"], 4)
        return d


class Superoptimizer:
    def __init__(self, memory, *, ledger=None, opt_every: int = 8,
                 beam_width: int = 3, max_steps: int = 3,
                 sim_budget: int = 24, per_template: int = 8,
                 margin: float = 0.0, stage: int = 3):
        """memory     the `PlanMemory` promotions land in
        ledger      optional `obs.monitor.PlanLedger`: template heat is
                    read from its observation counts (the RCA engine's
                    provenance stats) instead of local counters
        opt_every   run one search round per this many completions
        beam_width  surviving prefixes per depth
        max_steps   search depth (action-sequence length ceiling)
        sim_budget  hard cap on candidate simulations per round, shared
                    across however many templates the round sweeps
        per_template  per-key slice of the round budget — stops one
                    deep beam from starving the rest of the sweep
        margin      required modeled-cost improvement over the incumbent
        stage       curriculum stage for legality masks (3 = full space —
                    offline search is not subject to the live curriculum)
        """
        self.memory = memory
        self.ledger = ledger
        self.opt_every = max(int(opt_every), 1)
        self.beam_width = max(int(beam_width), 1)
        self.max_steps = max(int(max_steps), 1)
        self.sim_budget = max(int(sim_budget), 1)
        self.per_template = max(int(per_template), 1)
        self.margin = float(margin)
        self.stage = stage
        self.stats = SuperoptStats()
        self.promote_log: List[Dict] = []
        self._sched = None
        self._heat: Dict[Tuple[str, Tuple], int] = {}
        self._repr: Dict[Tuple[str, Tuple], object] = {}
        self._done: set = set()

    # ------------------------------------------------------------- plumbing
    def attach(self, scheduler) -> None:
        self._sched = scheduler
        scheduler.on_complete.append(self._on_complete)
        # after PlanMemory._on_delta in hook order (the memory attaches
        # first), so re-optimization sees entries already fenced and
        # `prior` hands back the stale sequence as a beam hint
        scheduler.on_delta.append(self._on_delta)

    def _on_complete(self, comp) -> None:
        t0 = time.perf_counter()
        self.stats.completions += 1
        key = (template_signature(comp.query),
               band_for(comp.query, self._sched.db.versions,
                        self.memory.band_width))
        self._heat[key] = self._heat.get(key, 0) + 1
        self._repr[key] = comp.query
        if self.stats.completions % self.opt_every == 0:
            self._round(comp.finish_t)
        self.stats.host_seconds += time.perf_counter() - t0

    def _on_delta(self, t_apply: float, delta) -> None:
        """Delta barrier: re-key heat for templates whose band the delta
        moved, then re-optimize immediately at the apply time — the
        promotions land before any post-delta admission probes the
        memory."""
        t0 = time.perf_counter()
        versions = self._sched.db.versions
        moved = 0
        for sig, band in sorted(self._heat):
            if all(t != delta.table for t, _ in band):
                continue
            q = self._repr[(sig, band)]
            nb = band_for(q, versions, self.memory.band_width)
            if nb == band:
                continue
            nk = (sig, nb)
            self._heat[nk] = self._heat.get(nk, 0) + \
                self._heat.pop((sig, band))
            self._repr[nk] = self._repr.pop((sig, band))
            self._done.discard(nk)
            moved += 1
        if moved:
            # every moved template gets its full slice: re-promotion at
            # the barrier is worth more than a cadence round's cap
            self._round(t_apply, budget=self.per_template * moved)
        self.stats.host_seconds += time.perf_counter() - t0

    # ------------------------------------------------------------ selection
    def _heat_of(self, key: Tuple[str, Tuple]) -> int:
        if self.ledger is None:
            return self._heat[key]
        q = self._repr[key]
        n = sum(st[0] for (_, tmpl, band), st in self.ledger._stats.items()
                if tmpl == q.name and band == key[1])
        return n if n else self._heat[key]

    def _pick(self) -> Optional[Tuple[str, Tuple]]:
        """Hottest (template, band) not yet optimized whose band still
        matches the live catalog (a delta since the last sighting moves
        the key off its band — let a future completion re-heat it)."""
        versions = self._sched.db.versions
        cands = []
        for key in self._heat:
            if key in self._done:
                continue
            if band_for(self._repr[key], versions,
                        self.memory.band_width) != key[1]:
                continue
            cands.append((-self._heat_of(key), key))
        if not cands:
            return None
        return min(cands)[1]

    # ----------------------------------------------------------- simulation
    def _simulate(self, q, prefix: Tuple[int, ...], space):
        """Run `q` with `prefix` applied at its first stage boundaries and
        noop thereafter; returns (modeled cost, mask after the prefix).
        reuse_stages=False keeps the sim off the serving stage cache — no
        serving-visible side effects, fully deterministic."""
        sched = self._sched
        run = AdaptiveRun(sched.db, q, syntactic_plan(q), sched.est,
                          sched.cluster, max_hook_steps=len(prefix) + 1,
                          reuse_stages=False)
        state = run.start()
        for a in prefix:
            if state is None:
                break
            new_plan, _, _ = apply_action(space, state, a)
            state = run.resume(new_plan)
        mask = None if state is None else \
            action_mask(space, state, stage=self.stage)
        while state is not None:
            state = run.resume(None)
        self.stats.sims += 1
        res = run.result
        return (_INF if res.failed else res.latency), mask

    # --------------------------------------------------------------- search
    def _round(self, now: float, budget: Optional[int] = None) -> None:
        """One cadence round: sweep hottest-first templates, spending the
        shared `sim_budget` across as many keys as it covers."""
        self.stats.rounds += 1
        budget = self.sim_budget if budget is None else budget
        while budget > 0:
            key = self._pick()
            if key is None:
                break
            self._done.add(key)
            budget -= self._search(key, now,
                                   min(budget, self.per_template))

    def _search(self, key: Tuple[str, Tuple], now: float,
                budget: int) -> int:
        """Beam-search one (template, band) under `budget` simulations;
        returns the simulations spent."""
        q = self._repr[key]
        space = self._sched.agent.space
        versions = self._sched.db.versions

        base_cost, base_mask = self._simulate(q, (), space)
        sims = 1
        prior = self.memory.prior(q, versions)
        inc_cost = base_cost
        inc_actions: Tuple[int, ...] = ()
        best = (base_cost, ())
        # beam: (cost, prefix, mask-after-prefix); expansion order is
        # fully sorted, so the search is deterministic
        beam = [(base_cost, (), base_mask)]
        if prior is not None and prior.actions and sims < budget:
            c, m = self._simulate(q, prior.actions, space)
            sims += 1
            if not prior.fenced:
                # re-simulated on the live db: the freshest incumbent cost
                inc_cost, inc_actions = c, prior.actions
            if c < best[0]:
                best = (c, prior.actions)
            beam.append((c, prior.actions, m))

        for _ in range(self.max_steps):
            cands = []
            for cost, prefix, mask in beam:
                if mask is None or len(prefix) >= self.max_steps:
                    continue
                legal = sorted(int(i) for i in range(space.d)
                               if mask[i] > 0 and i != space.noop_idx)
                for a in legal:
                    if sims >= budget:
                        break
                    c, m = self._simulate(q, prefix + (a,), space)
                    sims += 1
                    cands.append((c, prefix + (a,), m))
            if not cands:
                break
            cands.sort(key=lambda x: (x[0], x[1]))
            beam = cands[:self.beam_width]
            if beam[0][0] < best[0]:
                best = (beam[0][0], beam[0][1])

        cost, actions = best
        if cost < _INF and cost + self.margin < inc_cost \
                and actions != inc_actions:
            self.memory.install(
                q, versions, actions, cost=cost, source="superopt",
                decoded=tuple(str(space.decode(a)) for a in actions),
                t=now)
            self.stats.promotions += 1
            self.promote_log.append(
                {"query": q.name, "band": [list(b) for b in key[1]],
                 "actions": list(actions),
                 "cost": round(cost, 6),
                 "incumbent_cost": round(inc_cost, 6)
                 if inc_cost < _INF else None,
                 "sims": sims, "t": round(now, 4)})
        else:
            self.stats.skipped_no_gain += 1
        return sims

    def summary(self) -> Dict:
        return {**self.stats.as_dict(),
                "templates_seen": len(self._heat),
                "templates_done": len(self._done),
                "promote_log": list(self.promote_log)}
