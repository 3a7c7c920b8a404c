"""StreamSampler: seeded delta/tenant/fault arrival streams for a world.

Composes the serve-layer primitives into one ready-to-run `Arrival`
list, all drawn from a single seed:

  deltas   mixed append / update (append+delete) / delete `DeltaBatch`es
           cycling over the schema's `delete_safe_tables` (no dangling
           fks by construction), merged at deterministic times so they
           act as write barriers for every tenant;
  tenants  1-3 tenants with their own Poisson rates and SLOs over
           disjoint slices of the workload's train queries, via
           `driver.multi_tenant_stream` (each tenant's sub-stream is
           identical alone or in the mix);
  bursts   optionally one burst tenant: a short, hot arrival clump
           starting mid-horizon — the overload shape the QoS admission
           and SLO watchdog suites care about;
  faults   a sampled `FaultInjector` profile (crash/transient/slow
           probabilities, optionally confined to a seq window = a
           seeded outage burst). Returned as kwargs so callers opt in;
           `make_fault_injector` builds the injector.

Everything is a pure function of (spec, workload, profile, seed): same
inputs, same stream, bit-for-bit — pinned by tests/test_gen.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.gen.spec import SchemaSpec, delete_safe_tables
from repro_torch.serve.deltas import DeltaBatch
from repro_torch.serve.driver import TenantTraffic, multi_tenant_stream
from repro_torch.serve.recover.faults import FaultInjector
from repro_torch.serve.scheduler import Arrival

__all__ = ["StreamProfile", "sample_profile", "build_stream",
           "make_fault_injector"]

_DELTA_KINDS = ("append", "update", "delete")


@dataclasses.dataclass(frozen=True)
class StreamProfile:
    """One sampled serving scenario (plain data; `build_stream` renders
    it against a concrete workload)."""
    n_queries: int
    rate: float
    n_tenants: int
    slos: Tuple[Optional[float], ...]      # per tenant; None = best-effort
    delta_every: int                       # 0 = static data
    delta_rows: int
    delete_frac: float
    delta_tables: Tuple[str, ...]
    burst: Optional[Tuple[float, float, int]]  # (start_frac, rate_mult, n)
    faults: Tuple[Tuple[str, float], ...]  # FaultInjector kwargs (sorted)

    def fault_kwargs(self) -> Dict:
        return dict(self.faults)


def sample_profile(spec: SchemaSpec, seed: int, *,
                   n_queries: int = 30) -> StreamProfile:
    """Draw one scenario shape for `spec`. Fault probabilities are kept
    small enough that most queries succeed (the recover ladder, not the
    stream, is under test when they fire)."""
    rng = np.random.default_rng(seed)
    rate = round(float(rng.uniform(1.0, 6.0)), 2)
    n_tenants = int(rng.integers(1, 4))
    slos = tuple(None if rng.random() < 0.3
                 else round(float(rng.uniform(40.0, 400.0)), 1)
                 for _ in range(n_tenants))
    targets = delete_safe_tables(spec)
    delta_every = 0 if (not targets or rng.random() < 0.25) else \
        int(rng.integers(4, 12))
    delta_rows = int(rng.integers(200, 2000))
    delete_frac = round(float(rng.uniform(0.02, 0.15)), 3)
    burst = None
    if rng.random() < 0.4:
        burst = (round(float(rng.uniform(0.3, 0.7)), 2),
                 round(float(rng.uniform(2.0, 5.0)), 1),
                 int(rng.integers(4, 10)))
    faults: Dict[str, float] = {}
    if rng.random() < 0.5:
        faults["p_transient"] = round(float(rng.uniform(0.01, 0.08)), 3)
    if rng.random() < 0.3:
        faults["p_crash"] = round(float(rng.uniform(0.01, 0.05)), 3)
    if rng.random() < 0.4:
        faults["p_slow"] = round(float(rng.uniform(0.02, 0.10)), 3)
    if faults and rng.random() < 0.5:      # seeded outage burst
        lo = int(rng.integers(0, max(1, n_queries // 2)))
        faults["window"] = (lo, lo + int(rng.integers(4, n_queries)))
    return StreamProfile(
        n_queries=n_queries, rate=rate, n_tenants=n_tenants, slos=slos,
        delta_every=delta_every, delta_rows=delta_rows,
        delete_frac=delete_frac, delta_tables=targets, burst=burst,
        faults=tuple(sorted(faults.items())))


def _delta_arrivals(profile: StreamProfile, horizon: float,
                    rng) -> List[Arrival]:
    if not profile.delta_every or not profile.delta_tables:
        return []
    n = max(1, profile.n_queries // profile.delta_every)
    times = np.sort(rng.uniform(0.0, horizon, size=n))
    out = []
    for k in range(n):
        kind = _DELTA_KINDS[k % len(_DELTA_KINDS)]
        table = profile.delta_tables[k % len(profile.delta_tables)]
        out.append(Arrival(float(times[k]), delta=DeltaBatch(
            table,
            n_append=0 if kind == "delete" else profile.delta_rows,
            delete_frac=0.0 if kind == "append" else profile.delete_frac,
            seed=int(rng.integers(2 ** 31)))))
    return out


def build_stream(workload, profile: StreamProfile,
                 seed: int) -> List[Arrival]:
    """Render `profile` against `workload`: tenants cycle disjoint slices
    of the train queries (so the stream exercises every template), plus
    the profile's deltas and optional burst tenant, merged on the
    virtual clock."""
    rng = np.random.default_rng(seed)
    qs = list(workload.train)
    per = max(1, len(qs) // profile.n_tenants)
    traffics = []
    share = max(1, profile.n_queries // profile.n_tenants)
    for i in range(profile.n_tenants):
        chunk = qs[i * per:(i + 1) * per] or qs
        traffics.append(TenantTraffic(
            f"t{i}", chunk, rate=profile.rate / profile.n_tenants,
            n_queries=share, slo=profile.slos[i],
            seed=int(rng.integers(2 ** 31))))
    horizon = profile.n_queries / profile.rate
    if profile.burst is not None:
        start_frac, mult, n_b = profile.burst
        traffics.append(TenantTraffic(
            "burst", qs[:per] or qs, rate=profile.rate * mult,
            n_queries=n_b, slo=None, seed=int(rng.integers(2 ** 31)),
            start=horizon * start_frac))
    deltas = _delta_arrivals(profile, horizon, rng)
    return multi_tenant_stream(traffics, deltas=deltas)


def make_fault_injector(profile: StreamProfile,
                        seed: int) -> Optional[FaultInjector]:
    """The profile's chaos, keyed by `seed`; None when the profile drew
    no faults (the common case — streams are mostly healthy)."""
    kw = profile.fault_kwargs()
    if not kw:
        return None
    return FaultInjector(seed=seed, **kw)
