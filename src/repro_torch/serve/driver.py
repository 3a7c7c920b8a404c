"""Streaming workload driver: open-loop arrivals for the query service.

Generates a trace of `scheduler.Arrival`s — queries instantiated from the
JOB/ExtJOB/STACK templates (or any caller-supplied query source) with
exponential (Poisson-process) interarrival gaps, optionally interleaved
with delta batches every `delta_every` queries so the stream exercises the
cache's version-tag invalidation. Open-loop means arrival times never wait
on completions: when the service falls behind, queueing delay shows up in
the reported p50/p99 — the honest way to measure a serving system.

The trace is a plain list, so the same stream can be replayed against
different scheduling policies (async vs lockstep) for apples-to-apples
comparisons.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serve.deltas import FACT_TABLES, DeltaBatch
from repro_torch.serve.scheduler import Arrival
from repro_torch.sql import workloads


def _query_source(source, seed: int) -> Iterator:
    if isinstance(source, str):                  # benchmark name
        return workloads.query_stream(source, seed=seed)
    if hasattr(source, "__next__"):              # already a generator
        return source

    def cycle(qs):
        i = 0
        while True:
            yield qs[i % len(qs)]
            i += 1
    return cycle(list(source))


def open_loop_stream(source: Union[str, Iterable], *, rate: float,
                     n_queries: int, seed: int = 0,
                     delta_every: int = 0,
                     delta_tables: Sequence[str] = (),
                     delta_rows: int = 0,
                     delete_frac: float = 0.0,
                     start: float = 0.0,
                     tenant: str = "default",
                     slo: Optional[float] = None) -> List[Arrival]:
    """Build an open-loop trace: `n_queries` arrivals at `rate` qps.

    source       benchmark name ("job"/"extjob"/"stack"), a query list
                 (cycled), or a query generator.
    delta_every  inject one DeltaBatch after every `delta_every` queries,
                 round-robin over `delta_tables` (defaults to the
                 benchmark's fact tables), each appending `delta_rows`
                 rows and deleting `delete_frac` of the table.
    tenant/slo   stamp every query arrival with this tenant id and (when
                 `slo` is set) an absolute deadline of arrival + slo.
    """
    rng = np.random.default_rng(seed)
    qs = _query_source(source, seed)
    if delta_every and not delta_tables:
        assert isinstance(source, str), "delta_tables required for " \
            "non-benchmark sources"
        delta_tables = FACT_TABLES[source]
    t = start
    out: List[Arrival] = []
    n_deltas = 0
    for i in range(n_queries):
        t += float(rng.exponential(1.0 / rate))
        out.append(Arrival(t, query=next(qs),
                           seed=int(rng.integers(2 ** 31)),
                           tenant=tenant,
                           deadline=None if slo is None else t + slo))
        if delta_every and (i + 1) % delta_every == 0:
            table = delta_tables[n_deltas % len(delta_tables)]
            out.append(Arrival(t, delta=DeltaBatch(
                table, n_append=delta_rows, delete_frac=delete_frac,
                seed=int(rng.integers(2 ** 31)))))
            n_deltas += 1
    return out


@dataclasses.dataclass
class TenantTraffic:
    """One tenant's open-loop traffic for `multi_tenant_stream`."""
    tenant: str
    source: Union[str, Iterable]      # as open_loop_stream's `source`
    rate: float                       # this tenant's own Poisson rate
    n_queries: int
    slo: Optional[float] = None       # relative deadline (virtual seconds)
    seed: int = 0
    start: float = 0.0


def multi_tenant_stream(traffics: Sequence[TenantTraffic], *,
                        deltas: Sequence[Arrival] = ()) -> List[Arrival]:
    """Merge per-tenant open-loop traces into one arrival stream.

    Each tenant's trace is generated independently (own source, rate,
    seed, SLO) and the union is stable-sorted by arrival time, so any
    tenant's sub-stream is identical whether it serves alone or in the
    mix — the property the isolation tests replay against. Optional
    `deltas` (Arrivals with `delta` set) are merged at their own times
    and act as write barriers for every tenant.
    """
    out: List[Arrival] = []
    for tr in traffics:
        out.extend(open_loop_stream(
            tr.source, rate=tr.rate, n_queries=tr.n_queries, seed=tr.seed,
            start=tr.start, tenant=tr.tenant, slo=tr.slo))
    out.extend(deltas)
    return sorted(out, key=lambda a: a.t)
