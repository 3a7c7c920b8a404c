"""Online serving subsystem: an async-lane query service on top of the
resumable `sql.executor.AdaptiveRun` suspension points.

Architecture
------------
Four cooperating pieces, each in its own module:

  cache.py      Runtime stage/statistics cache. Replaces the executor's
                ad-hoc clear-all dict: LRU eviction under a byte budget,
                per-table version tags baked into every signature (so a
                table update invalidates all derived entries in O(1) —
                stale signatures simply never match again and age out via
                LRU), and hit/miss/evict/invalidate counters.

  scheduler.py  The async lane scheduler. A fixed pool of lanes, each
                holding one suspended `AdaptiveRun`; at every tick,
                whichever lanes are currently suspended at a stage
                boundary are gathered into ONE batched policy call
                (`agent.act_batch`) — no global barrier. Lanes join and
                leave mid-flight; a finished lane is immediately refilled
                from the admission queue. Completion times live on a
                deterministic virtual clock (admission time + the run's
                simulated latency), so serial execution (n_lanes=1) and
                lockstep batching (policy="lockstep", the original engine)
                remain bit-reproducible special cases of the same loop.

  deltas.py     Delta-table dynamic workloads: append/delete batches that
                mutate the live database between queries and bump the
                per-table version, making stale cache entries provably
                wrong if ever served. The scheduler applies a delta as a
                write barrier: every query admitted before it drains
                first, every query after it sees the new version.

  driver.py     Streaming workload driver: open-loop (Poisson) arrivals
                instantiated from the JOB/ExtJOB/STACK templates, with
                optional interleaved delta batches.

  service.py    Façade tying it together: `QueryService.run(stream)`
                installs the cache, runs the scheduler, and reports
                throughput (qps), p50/p99 latency (with the queue-wait /
                in-lane breakdown), and cache hit rate — the numbers
                `benchmarks/bench_serve.py` persists to
                results/BENCH_serve.json. With a tenant registry the
                stats gain a per-tenant breakdown (SLO-miss rate,
                rejected/degraded counts, partition cache counters).

  recover/      Failure-recovery control plane: seeded FaultInjector,
                stage-resume retry ladder with re-planned OOM fallbacks,
                hedged stragglers, and the post-swap policy circuit
                breaker — all wired in through one `RecoveryManager`
                passed as `LaneScheduler(recovery=...)`. Inert by
                default: without it (or with the injector disabled and
                no retry/hedge/breaker) completions are bit-identical.

  obs/          Deterministic observability plane: per-query span trees
                on the virtual clock (`Tracer`), fixed-bucket metrics
                sampled into a time series (`MetricsRegistry`), Chrome-
                trace/JSONL export with a schema validator, a bounded
                flight recorder, and the trace-diff explainer. Attached
                via `QueryService(obs=Tracer())`; obs=None keeps every
                emit point short-circuited and completions bit-identical.

  qos/          SLO-aware multi-tenant control plane: tenant registry
                (token buckets, fair share, cache budgets), admission-
                time latency predictor, degradation ladder, and the
                pluggable `AdmissionPolicy` the scheduler consults —
                see qos/__init__.py and README.md.

Imports are lazy so that `sql.executor` can depend on `serve.cache`
without creating an import cycle through this package.
"""
from __future__ import annotations

_EXPORTS = {
    "StageCache": "repro_torch.serve.cache",
    "CacheStats": "repro_torch.serve.cache",
    "PartitionedStageCache": "repro_torch.serve.cache",
    "Arrival": "repro_torch.serve.scheduler",
    "Completion": "repro_torch.serve.scheduler",
    "Rejection": "repro_torch.serve.scheduler",
    "LaneScheduler": "repro_torch.serve.scheduler",
    "DeltaBatch": "repro_torch.serve.deltas",
    "apply_delta": "repro_torch.serve.deltas",
    "open_loop_stream": "repro_torch.serve.driver",
    "multi_tenant_stream": "repro_torch.serve.driver",
    "TenantTraffic": "repro_torch.serve.driver",
    "QueryService": "repro_torch.serve.service",
    "ServiceStats": "repro_torch.serve.service",
    "TenantStats": "repro_torch.serve.service",
    "AdmissionPolicy": "repro_torch.serve.qos",
    "DriftController": "repro_torch.serve.drift",
    "DriftDetector": "repro_torch.serve.drift",
    "RefreshPolicy": "repro_torch.serve.drift",
    "CoverageProbeSet": "repro_torch.serve.drift",
    "QoSAdmission": "repro_torch.serve.qos",
    "FaultInjector": "repro_torch.serve.recover",
    "ScriptedFaults": "repro_torch.serve.recover",
    "RetryPolicy": "repro_torch.serve.recover",
    "HedgePolicy": "repro_torch.serve.recover",
    "PolicyBreaker": "repro_torch.serve.recover",
    "RecoveryManager": "repro_torch.serve.recover",
    "RecoveryStats": "repro_torch.serve.recover",
    "Tracer": "repro_torch.serve.obs",
    "MetricsRegistry": "repro_torch.serve.obs",
    "FlightRecorder": "repro_torch.serve.obs",
    "DegradationLadder": "repro_torch.serve.qos",
    "LatencyPredictor": "repro_torch.serve.qos",
    "TenantRegistry": "repro_torch.serve.qos",
    "TenantSpec": "repro_torch.serve.qos",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)
