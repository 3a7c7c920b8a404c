"""The drift controller: one scheduler hook wiring detection to its three
actuators.

Attached via `QueryService(hooks=[DriftController(...)])` (after the
harvester, so replay regret for the triggering completion is already
up to date), the controller runs entirely inside `on_complete` — between
policy batches, in deterministic completion order — and:

  1. feeds the `DriftDetector` each completion's execution evidence
     (latency regret from the replay buffer's per-template bests,
     relative predicted-vs-actual error from the QoS predictor);

  2. asks the `RefreshPolicy` which drifted tables earn a re-ANALYZE and
     schedules one `LaneScheduler.schedule_barrier` task for them: the
     task drains in-flight queries (a stats swap mid-query would make a
     run's planning inconsistent), runs `catalog.analyze_table`
     incrementally per table, and charges an EXPLICIT cost — modeled
     seconds from the cluster's scan model (deterministic; optionally
     also pushed onto the virtual clock with `charge_virtual=True`, so
     refresh delays traffic like a real maintenance window) plus
     measured wall seconds (reported, never consulted);

  3. refits the `LatencyPredictor` from the LIVE replay buffer when the
     peak drift score crosses `refit_threshold` (generation-fenced,
     cooldown `refit_every` completions) — replacing one-shot
     calibration;

  4. re-samples the `PolicyStore` gate probes through `CoverageProbeSet`
     whenever the set of above-threshold tables changes, so candidates
     are gated on the traffic that actually drifted.

Every decision consumes only virtual-clock state, modeled costs and
seeded RNGs: a run with the controller attached is bit-reproducible, and
with `RefreshPolicy("never")` + no refit/probe actuators it is
completion-bit-identical to a run with no controller at all (pinned by
tests/test_drift.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.drift.detector import DriftDetector
from repro_torch.serve.drift.policy import RefreshPolicy
from repro_torch.serve.drift.probes import CoverageProbeSet
from repro_torch.sql.catalog import analyze_table

__all__ = ["DriftController", "DriftStats"]


@dataclasses.dataclass
class DriftStats:
    completions: int = 0
    refresh_events: int = 0            # barrier tasks run
    tables_refreshed: int = 0          # table re-ANALYZEs (events x tables)
    analyze_modeled_s: float = 0.0     # deterministic cluster-model price
    analyze_wall_s: float = 0.0        # measured host cost (reported only)
    refits: int = 0
    probe_resamples: int = 0
    curriculum_demotions: int = 0      # stage drops via note_drift
    host_seconds: float = 0.0          # controller's own on_complete cost

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in ("analyze_modeled_s", "analyze_wall_s", "host_seconds"):
            d[k] = round(d[k], 4)
        return d


class DriftController:
    def __init__(self, *, detector: Optional[DriftDetector] = None,
                 policy: Optional[RefreshPolicy] = None,
                 replay=None, predictor=None, store=None,
                 probes: Optional[CoverageProbeSet] = None,
                 curriculum=None, plan_memory=None,
                 refit_threshold: float = 1.0, refit_every: int = 8,
                 refit_samples: int = 64, refit_epochs: int = 2,
                 probe_threshold: float = 1.0,
                 sample_frac: float = 0.05, charge_virtual: bool = False,
                 seed: int = 0):
        """`replay` is the original `learn.ReplayBuffer` (regret source and the
        refit training set); `predictor` the QoS `LatencyPredictor` (error
        source and refit target); `store` the `learn.PolicyStore` whose
        probe set `probes` re-covers; `curriculum` an
        `learn.AdaptiveCurriculum` (with `drift_demote_threshold` set)
        that gets the peak drift score per completion — the fourth
        actuator: detector-attributed drift demotes the serving stage
        (share the instance with the `BackgroundLearner`, which copies
        `stage` onto the scheduler between ticks). All are optional: the
        detector scores from catalog lag alone when evidence sources are
        absent, and actuators without their dependency simply stay off.
        `plan_memory` (a `serve.plans.PlanMemory`) gets `note_stats_refresh`
        whenever a re-ANALYZE rewrites a table's statistics: the memory's
        entries on that table are fenced — demoted from blind replay to
        superoptimizer hint prior — because the plan that won under the
        old stats is no longer evidence under the new ones."""
        self.detector = detector if detector is not None else DriftDetector()
        self.policy = policy if policy is not None else RefreshPolicy("never")
        self.replay = replay
        self.predictor = predictor
        self.store = store
        self.probes = probes
        self.curriculum = curriculum
        self.plan_memory = plan_memory
        assert probes is None or store is not None, \
            "probe coverage needs a PolicyStore to install the set on"
        self.refit_threshold = refit_threshold
        self.refit_every = max(refit_every, 1)
        self.refit_samples = refit_samples
        self.refit_epochs = refit_epochs
        self.probe_threshold = probe_threshold
        self.sample_frac = sample_frac
        self.charge_virtual = charge_virtual
        self._refit_rng = np.random.default_rng(seed)
        self._analyze_rng = np.random.default_rng(seed + 1)
        self.stats = DriftStats()
        self.refresh_log: List[Dict] = []
        self._sched = None
        self._pending: set = set()       # tables in a scheduled, unrun task
        self._since_refit = 0
        self._probe_cover_set: tuple = ()  # drifted-table set last installed

    # ------------------------------------------------------------- plumbing
    def attach(self, scheduler) -> None:
        self._sched = scheduler
        self.detector.snapshot(scheduler.db)
        scheduler.on_complete.append(self._on_complete)
        scheduler.on_delta.append(self._on_delta)

    def scores(self):
        return self.detector.score(self._sched.db)

    def _analyze_cost_s(self, table: str) -> float:
        """Deterministic price of ANALYZE(table): the cluster's scan model
        over the bytes the sampler actually reads, plus one stage of
        scheduling overhead."""
        cl = self._sched.cluster
        nbytes = self._sched.db.table(table).bytes() * self.sample_frac
        return cl.scan_time(nbytes) + cl.stage_overhead

    # ----------------------------------------------------------- completion
    def _on_complete(self, comp) -> None:
        t0 = time.perf_counter()
        self.stats.completions += 1
        self._since_refit += 1
        tables = tuple(sorted({r.table for r in comp.query.relations}))
        regret = None
        if self.replay is not None:
            regret = self.replay.regret_for(comp.query.name,
                                            comp.result.latency)
        pred_err = None
        if self.predictor is not None:
            predicted = comp.predicted
            if predicted is None:
                predicted = self.predictor.predict_query(comp.query)
            actual = comp.result.latency
            pred_err = abs(predicted - actual) / max(actual, 1e-9)
        self.detector.observe(tables, regret=regret, pred_err=pred_err)

        # with no actuator able to consume them (never-policy, no refit
        # target, no probe pool) scoring the catalog per completion is
        # pure serving-path overhead — scores() stays available on demand
        if self.policy.kind != "never" or self.predictor is not None \
                or self.probes is not None or self.curriculum is not None:
            drifts = self.detector.score(self._sched.db)
            self._maybe_refresh(drifts, comp.finish_t)
            self._maybe_refit(drifts)
            self._maybe_recover_probes(drifts)
            self._maybe_demote_curriculum(drifts)
        self.stats.host_seconds += time.perf_counter() - t0

    def _on_delta(self, t_apply: float, delta) -> None:
        """Delta batches are where catalog lag is born — and the one point
        where every lane is already drained. Deciding a refresh HERE means
        the barrier task (scheduled from this hook) runs at the very same
        barrier, before any post-delta query is admitted: auto-ANALYZE
        triggered by DML, not by a later completion, with zero extra
        drain stall."""
        if self.policy.kind == "never":
            return                     # no actuator: keep the baseline free
        t0 = time.perf_counter()
        self._maybe_refresh(self.detector.score(self._sched.db), t_apply)
        self.stats.host_seconds += time.perf_counter() - t0

    # ------------------------------------------------------------ actuators
    def _maybe_refresh(self, drifts, now: float) -> None:
        dec = self.policy.decide(
            {t: d for t, d in drifts.items() if t not in self._pending},
            now, self._analyze_cost_s)
        if not dec.tables:
            return
        self._pending.update(dec.tables)
        self._sched.schedule_barrier(self._refresh_task(dec.tables),
                                     label=f"re-analyze:{','.join(dec.tables)}")

    def note_external_evidence(self, tables, now: float,
                               reason: str = "") -> tuple:
        """Opt-in alert path (serve.obs.AlertHooks): an external monitor
        attributed a live regression to stale stats on `tables` —
        schedule an immediate re-ANALYZE barrier for them, bypassing the
        RefreshPolicy's thresholds/budget (the policy prices routine
        maintenance; an attributed incident has already paid for it).
        Returns the tables actually scheduled."""
        avail = tuple(t for t in sorted(set(tables))
                      if t not in self._pending and t in self._sched.db.tables)
        if not avail:
            return ()
        self._pending.update(avail)
        self._sched.schedule_barrier(
            self._refresh_task(avail),
            label=f"re-analyze[alert]:{','.join(avail)}")
        return avail

    def _refresh_task(self, tables):
        def task(sched, t_apply: float):
            modeled_total = 0.0
            for t in tables:
                w0 = time.perf_counter()
                modeled = self._analyze_cost_s(t)   # pre-ANALYZE bytes
                ts = analyze_table(sched.db, t, self.sample_frac,
                                   rng=self._analyze_rng)
                version = sched.db.table_version(t)
                sched.db.stats.tables[t] = ts
                if sched.db.stats.versions is not None:
                    sched.db.stats.versions[t] = version
                est_stats = getattr(sched.est, "stats", None)
                if est_stats is not None and est_stats is not sched.db.stats:
                    est_stats.tables[t] = ts
                    if est_stats.versions is not None:
                        est_stats.versions[t] = version
                self.detector.note_refreshed(t, version)
                self.policy.note_refreshed(t, t_apply)
                self.stats.tables_refreshed += 1
                self.stats.analyze_modeled_s += modeled
                self.stats.analyze_wall_s += time.perf_counter() - w0
                modeled_total += modeled
            self._pending.difference_update(tables)
            self.stats.refresh_events += 1
            self.refresh_log.append(
                {"t": round(t_apply, 4), "tables": list(tables),
                 "modeled_s": round(modeled_total, 4)})
            if getattr(sched, "obs", None) is not None:
                sched.obs.event("re_analyze",
                                {"tables": list(tables),
                                 "modeled_s": round(modeled_total, 6)},
                                t=t_apply)
            if self.store is not None:
                # fresh stats change probe planning without a version bump:
                # the store's version-keyed incumbent cache must not survive
                self.store.note_stats_refresh()
            if self.plan_memory is not None:
                # same staleness, different store: memoized plans that won
                # under the old stats are fenced to hint-prior status
                self.plan_memory.note_stats_refresh(tables, t_apply)
            return modeled_total if self.charge_virtual else 0.0
        return task

    def _maybe_refit(self, drifts) -> None:
        if self.predictor is None or self.replay is None \
                or not len(self.replay):
            return
        if self._since_refit < self.refit_every:
            return
        peak = max((d.score for d in drifts.values()), default=0.0)
        if peak < self.refit_threshold:
            return
        n0 = self.predictor.n_refits
        self.predictor.refit_on_drift(
            self.replay, self._refit_rng,
            current_versions=dict(self._sched.db.versions),
            n_samples=self.refit_samples, epochs=self.refit_epochs,
            trigger=f"peak drift score {peak:.2f}")
        # a sample of all state-less trajectories trains nothing and is
        # not counted as a refit; the cooldown restarts either way
        refitted = self.predictor.n_refits > n0
        self.stats.refits += refitted
        self._since_refit = 0
        if refitted and getattr(self._sched, "obs", None) is not None:
            self._sched.obs.event("predictor_refit",
                                  {"peak_score": round(peak, 6),
                                   "n_refits": self.predictor.n_refits})

    def _maybe_demote_curriculum(self, drifts) -> None:
        if self.curriculum is None:
            return
        peak = max((d.score for d in drifts.values()), default=0.0)
        if self.curriculum.note_drift(peak):
            self.stats.curriculum_demotions += 1
            if getattr(self._sched, "obs", None) is not None:
                self._sched.obs.event(
                    "curriculum_demote",
                    {"peak_score": round(peak, 6),
                     "stage": self.curriculum.stage})

    def _maybe_recover_probes(self, drifts) -> None:
        if self.probes is None:
            return
        hot = tuple(sorted(t for t, d in drifts.items()
                           if d.score >= self.probe_threshold))
        if not hot or hot == self._probe_cover_set:
            return
        self.store.set_probe(self.probes.resample(drifts),
                             reason=f"drifted tables: {','.join(hot)}")
        self._probe_cover_set = hot
        self.stats.probe_resamples += 1
        if getattr(self._sched, "obs", None) is not None:
            self._sched.obs.event("probe_resample",
                                  {"drifted_tables": list(hot)})

    def summary(self) -> Dict:
        return {**self.stats.as_dict(),
                "detector": self.detector.stats(),
                "policy": self.policy.stats(),
                "predictor": None if self.predictor is None
                else self.predictor.stats(),
                "probes": None if self.probes is None
                else self.probes.stats()}
