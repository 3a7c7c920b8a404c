"""Service façade: one object that owns the cache, the scheduler and the
serving metrics.

`QueryService` installs a fresh `StageCache` on the database (so every
service instance starts with cold, independently-budgeted cache state),
runs an arrival stream through a `LaneScheduler`, and distills the
completions into the numbers a serving benchmark cares about: throughput
(qps on the virtual clock), p50/p99 query latency (queueing + execution)
with the queue-wait/in-lane breakdown, cache hit rate, and the host-side
cost of the policy (decision batches per tick, hook seconds per query).

With a `TenantRegistry` the cache becomes per-tenant partitions
(`PartitionedStageCache`) and the stats gain a per-tenant breakdown —
qps, p50/p99, SLO-miss rate, rejected/degraded counts, partition cache
counters; with an `AdmissionPolicy` (`serve.qos`) the scheduler runs
admission control / EDF / degradation. Both default to off, keeping the
original serving path bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.cache import PartitionedStageCache, StageCache
from repro_torch.serve.scheduler import (Arrival, Completion, LaneScheduler,
                                   Rejection)
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel


def _round_floats(x):
    if isinstance(x, float):
        return round(x, 4)
    if isinstance(x, dict):
        return {k: _round_floats(v) for k, v in x.items()}
    return x


@dataclasses.dataclass
class TenantStats:
    """Per-tenant slice of a serving run (virtual-clock metrics)."""
    n_completed: int = 0
    n_failed: int = 0
    n_rejected: int = 0
    n_degraded: int = 0
    n_slo_miss: int = 0               # completed past their deadline
    slo_miss_rate: float = 0.0        # misses / completed-with-deadline
    qps: float = 0.0                  # completions / global makespan
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    queue_wait_mean: float = 0.0
    cache: Optional[Dict[str, float]] = None   # this tenant's partition
    failure_kinds: Optional[Dict[str, int]] = None  # failed, by kind
    n_recovered: int = 0              # succeeded after >=1 failed attempt
    n_hedged: int = 0                 # resolved through a hedge race
    # ---- SLO watchdog (serve.obs.monitor; 0 unless a monitor is attached)
    n_anomalies: int = 0              # detector alerts on this tenant's series
    n_incidents: int = 0              # incidents opened on this tenant

    def as_dict(self) -> Dict:
        return _round_floats(dataclasses.asdict(self))


@dataclasses.dataclass
class ServiceStats:
    n_completed: int
    n_failed: int
    makespan: float                  # first arrival -> last completion (s)
    qps: float
    latency_mean: float              # arrival -> completion, virtual secs
    latency_p50: float
    latency_p99: float
    service_mean: float              # in-lane: admission -> completion
    cache: Optional[Dict[str, float]]
    ticks: int
    mean_decide_batch: float
    hook_seconds: float              # total host-side policy cost
    queue_wait_mean: float = 0.0     # in admission queue: arrival -> admit
    queue_wait_p99: float = 0.0
    n_rejected: int = 0              # turned away at admission
    n_degraded: int = 0              # admitted with a shrunken hook budget
    n_slo_miss: int = 0
    slo_miss_rate: float = 0.0       # over completed queries with deadlines
    per_tenant: Optional[Dict[str, TenantStats]] = None
    # ---- failure-recovery breakdown (serve.recover) ---------------------
    failure_kinds: Optional[Dict[str, int]] = None  # failed comps, by kind
    #   (oom vs timeout vs injected crash/transient)
    attempts_total: int = 0          # lane admissions incl. retries
    n_retried: int = 0               # completions that needed >1 attempt
    n_recovered: int = 0             # succeeded after >=1 failed attempt
    n_hedged: int = 0                # resolved through a hedge race
    # ---- SLO watchdog totals (serve.obs.monitor) ------------------------
    n_anomalies: int = 0             # detector alerts, all series
    n_incidents: int = 0             # incidents opened
    # ---- plan memory (serve.plans; None unless one is attached) ---------
    n_memoized: int = 0              # completions served by memo replay
    plan_memory: Optional[Dict] = None   # PlanMemory.stats() counters

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return _round_floats(d)


def _slo_counts(comps: List[Completion]) -> Tuple[int, float]:
    with_dl = [c for c in comps if c.deadline is not None]
    n_miss = sum(c.slo_miss for c in with_dl)
    return n_miss, (n_miss / len(with_dl) if with_dl else 0.0)


def _failure_kinds(comps: List[Completion]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in comps:
        if c.result.failed:
            k = c.failure_kind or "unknown"
            out[k] = out.get(k, 0) + 1
    return out


class QueryService:
    """Online query service over a database + trained (or cold) agent."""

    def __init__(self, db, agent, *, est: Optional[Estimator] = None,
                 cluster: Optional[ClusterModel] = None, n_lanes: int = 8,
                 policy: str = "async", window: Optional[float] = None,
                 cache_bytes: int = 256 * 1024 * 1024,
                 reuse_stages: bool = True, explore: bool = False,
                 hooks: Sequence = (), tenants=None, admission=None,
                 recovery=None, obs=None, monitor=None, plan_memory=None):
        """`hooks` are objects with an `attach(scheduler)` method (e.g. the
        lifelong-learning loop's `learn.TrajectoryHarvester` /
        `learn.BackgroundLearner`); each is attached to every scheduler
        this service creates, in order. `explore=True` samples the policy
        instead of taking argmax — the online loop uses it to keep
        gathering off-greedy experience while serving.

        `tenants` (a `serve.qos.TenantRegistry`) partitions the stage
        cache per tenant (each spec's `cache_bytes`, else `cache_bytes`)
        and switches the stats to a per-tenant breakdown. `admission` (a
        `serve.qos.AdmissionPolicy`) plugs admission control into every
        scheduler this service creates. `recovery` (a
        `serve.recover.RecoveryManager`) plugs the failure-recovery
        control plane in the same way. `obs` (a `serve.obs.Tracer`)
        attaches the observability plane — BEFORE the hooks, so hook
        attach seams (learner/breaker) can wire their own emit paths to
        it. `monitor` (a `serve.obs.SloMonitor`) attaches the online SLO
        watchdog AFTER the hooks — it reads each completion's assembled
        span tree, so the tracer (auto-created when `obs` is None) must
        observe first. `plan_memory` (a `serve.plans.PlanMemory`) attaches
        the memoized-replay fast path right after the tracer (its events
        need `scheduler.obs` live) and before the hooks (so harvesters see
        `comp.memoized`). All None = the original path, bit-identical; a
        monitor with alerts unwired keeps completions bit-identical too."""
        self.db = db
        self.agent = agent
        self.est = est if est is not None else Estimator(db, db.stats)
        self.cluster = cluster if cluster is not None else ClusterModel()
        self.n_lanes, self.policy, self.window = n_lanes, policy, window
        self.reuse_stages = reuse_stages
        self.explore = explore
        self.hooks = list(hooks)
        self.tenants = tenants
        self.admission = admission
        self.recovery = recovery
        if monitor is not None and obs is None:
            from repro_torch.serve.obs import Tracer
            obs = Tracer()
        self.obs = obs
        self.monitor = monitor
        self.plan_memory = plan_memory
        if reuse_stages:
            if tenants is not None:
                # every REGISTERED tenant gets its own partition (explicit
                # budget or the service default); unregistered ids share
                # the default partition, so memory stays bounded
                budgets = {t: tenants.spec(t).cache_bytes
                           if tenants.spec(t).cache_bytes is not None
                           else cache_bytes for t in tenants.tenants}
                self.cache = PartitionedStageCache(
                    default_bytes=cache_bytes, budgets=budgets)
            else:
                self.cache = StageCache(max_bytes=cache_bytes)
            db._stage_cache = self.cache     # shared by every AdaptiveRun
        else:
            self.cache = None
        self.scheduler: Optional[LaneScheduler] = None

    def run(self, stream: Sequence[Arrival]) \
            -> Tuple[List[Completion], ServiceStats]:
        """Serve `stream` to completion; returns (completions, stats)."""
        self.scheduler = LaneScheduler(
            self.db, self.est, self.agent, n_lanes=self.n_lanes,
            explore=self.explore, cluster=self.cluster, policy=self.policy,
            window=self.window, reuse_stages=self.reuse_stages,
            admission=self.admission, recovery=self.recovery)
        if self.obs is not None:
            self.obs.attach(self.scheduler)
        if self.plan_memory is not None:
            self.plan_memory.attach(self.scheduler)
        for h in self.hooks:
            h.attach(self.scheduler)
        if self.monitor is not None:
            # last attacher: the monitor consumes the span trees the
            # tracer's own on_complete assembles
            self.monitor.attach(self.scheduler)
        comps = self.scheduler.run(list(stream))
        if self.monitor is not None:
            self.monitor.finalize()
        return comps, self._stats(comps)

    def reset_stats(self, *, clear_entries: bool = False) -> None:
        """Zero the measurement state that otherwise ACCUMULATES across
        `run()` calls sharing this service's executor state: stage-cache
        counters (all partitions) and, when the admission policy carries a
        `LatencyPredictor`, its per-query prediction memos. With
        `clear_entries=True` the cache contents are dropped too, so the
        next run starts cold — on an unmutated database that makes two
        identical streams produce identical stats end to end."""
        if self.cache is not None:
            self.cache.reset_stats()
            if clear_entries:
                self.cache.clear()
        pred = getattr(self.admission, "predictor", None)
        if pred is not None and hasattr(pred, "reset_stats"):
            pred.reset_stats()
        if self.obs is not None:
            # spans, events, metrics registry and flight recorder all
            # accumulate across run() calls — same discipline as the
            # cache counters above
            self.obs.reset()
        if self.monitor is not None:
            # detector baselines, anomaly/incident history and the
            # plan-provenance ledger accumulate the same way
            self.monitor.reset()
        if self.plan_memory is not None:
            # probe/hit/promotion counters accumulate across runs; the
            # ENTRIES only drop with clear_entries (they are the product)
            self.plan_memory.reset_stats(clear_entries=clear_entries)

    def run_queries(self, queries: Sequence, *, seeds=None) \
            -> Tuple[List[Completion], ServiceStats]:
        """Closed batch convenience: all queries arrive at t=0."""
        if seeds is None:
            seeds = range(len(queries))
        return self.run([Arrival(0.0, query=q, seed=s)
                         for q, s in zip(queries, seeds)])

    # -------------------------------------------------------------- stats
    def _cache_dict(self) -> Optional[Dict[str, float]]:
        if self.cache is None:
            return None
        if isinstance(self.cache, PartitionedStageCache):
            return self.cache.aggregate_stats()
        return self.cache.stats.as_dict()

    def _tenant_stats(self, comps: List[Completion],
                      rejects: List[Rejection], makespan: float) \
            -> Dict[str, TenantStats]:
        names = sorted({c.tenant for c in comps} |
                       {r.tenant for r in rejects} |
                       (set(self.tenants.tenants)
                        if self.tenants is not None else set()))
        parts = self.cache.partitions() \
            if isinstance(self.cache, PartitionedStageCache) else {}
        out = {}
        for name in names:
            cs = [c for c in comps if c.tenant == name]
            n_miss, miss_rate = _slo_counts(cs)
            lat = np.asarray([c.latency for c in cs]) if cs else None
            part = parts.get(name)
            n_anom, n_inc = self.monitor.tenant_counts(name) \
                if self.monitor is not None else (0, 0)
            out[name] = TenantStats(
                n_completed=len(cs),
                n_failed=sum(c.result.failed for c in cs),
                n_rejected=sum(r.tenant == name for r in rejects),
                n_degraded=sum(c.degraded for c in cs),
                n_slo_miss=n_miss, slo_miss_rate=miss_rate,
                qps=len(cs) / max(makespan, 1e-9),
                latency_p50=float(np.percentile(lat, 50)) if cs else 0.0,
                latency_p99=float(np.percentile(lat, 99)) if cs else 0.0,
                queue_wait_mean=float(np.mean([c.queue_wait for c in cs]))
                if cs else 0.0,
                cache=part.stats.as_dict() if part is not None else None,
                failure_kinds=_failure_kinds(cs) or None,
                n_recovered=sum(c.recovered for c in cs),
                n_hedged=sum(c.hedged for c in cs),
                n_anomalies=n_anom, n_incidents=n_inc)
        return out

    def _stats(self, comps: List[Completion]) -> ServiceStats:
        sched = self.scheduler
        rejects = sched.rejections
        # NB: `if self.cache` would be False for an EMPTY cache (StageCache
        # defines __len__) — the None-check matters on the empty-stream path
        if not comps:
            return ServiceStats(
                0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, self._cache_dict(),
                sched.ticks, 0.0, 0.0, n_rejected=len(rejects),
                per_tenant=self._tenant_stats([], rejects, 0.0)
                if self.tenants is not None else None,
                plan_memory=self.plan_memory.stats()
                if self.plan_memory is not None else None)
        lat = np.asarray([c.latency for c in comps])
        wait = np.asarray([c.queue_wait for c in comps])
        first = min(c.arrival_t for c in comps)
        makespan = max(c.finish_t for c in comps) - first
        n_miss, miss_rate = _slo_counts(comps)
        n_anom, n_inc = self.monitor.totals() \
            if self.monitor is not None else (0, 0)
        return ServiceStats(
            n_completed=len(comps),
            n_failed=sum(c.result.failed for c in comps),
            makespan=makespan,
            qps=len(comps) / max(makespan, 1e-9),
            latency_mean=float(lat.mean()),
            latency_p50=float(np.percentile(lat, 50)),
            latency_p99=float(np.percentile(lat, 99)),
            service_mean=float(np.mean([c.service_t for c in comps])),
            cache=self._cache_dict(),
            ticks=sched.ticks,
            mean_decide_batch=float(np.mean(sched.decide_sizes))
            if sched.decide_sizes else 0.0,
            hook_seconds=float(sum(c.traj.hook_seconds for c in comps)),
            queue_wait_mean=float(wait.mean()),
            queue_wait_p99=float(np.percentile(wait, 99)),
            n_rejected=len(rejects),
            n_degraded=sum(c.degraded for c in comps),
            n_slo_miss=n_miss, slo_miss_rate=miss_rate,
            per_tenant=self._tenant_stats(comps, rejects, makespan)
            if self.tenants is not None else None,
            failure_kinds=_failure_kinds(comps) or None,
            attempts_total=sum(c.attempts for c in comps),
            n_retried=sum(c.attempts > 1 for c in comps),
            n_recovered=sum(c.recovered for c in comps),
            n_hedged=sum(c.hedged for c in comps),
            n_anomalies=n_anom, n_incidents=n_inc,
            n_memoized=sum(c.memoized for c in comps),
            plan_memory=self.plan_memory.stats()
            if self.plan_memory is not None else None)
