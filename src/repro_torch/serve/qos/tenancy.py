"""Tenant registry: rate limits, fair-share accounting, SLO defaults.

Every `Arrival` carries a `tenant` id; the registry is where a tenant's
serving contract lives:

  rate/burst     a token bucket ON THE VIRTUAL CLOCK — refill is a pure
                 function of virtual time, so rate-limit decisions are
                 bit-reproducible. A tenant over its rate is never
                 rejected outright; its query is DEFERRED to the earliest
                 virtual time a token exists (`acquire` returns that
                 time), which shows up honestly as queueing latency.
  weight         weighted fair share over lane time: the registry
                 accumulates each tenant's virtual service seconds, and
                 `fair_key` (accumulated/weight) orders tenants the way a
                 stride scheduler would — the admission policy uses it to
                 break deadline ties, so a flooding tenant cannot starve
                 a light one even when both are inside their rate.
  slo            default relative deadline (virtual seconds) stamped onto
                 arrivals that don't carry one.
  cache_bytes    this tenant's partition budget in the
                 `PartitionedStageCache` (None = the partition default).

Unknown tenants resolve to a permissive default spec, so single-tenant
streams need no registry setup at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    tenant: str
    weight: float = 1.0               # fair-share weight (>0)
    rate: Optional[float] = None      # admitted queries / virtual second
    burst: int = 1                    # token-bucket depth
    slo: Optional[float] = None       # default deadline = arrival + slo
    cache_bytes: Optional[int] = None  # stage-cache partition budget


@dataclasses.dataclass
class _Bucket:
    tokens: float
    last_t: float


class TenantRegistry:
    def __init__(self, specs=()):
        self._specs: Dict[str, TenantSpec] = {}
        self._buckets: Dict[str, _Bucket] = {}
        self._service: Dict[str, float] = {}   # virtual service secs used
        self._admitted: Dict[str, int] = {}
        for s in specs:
            self.register(s)

    def register(self, spec: TenantSpec) -> TenantSpec:
        assert spec.weight > 0, "fair-share weight must be positive"
        if spec.rate is not None:
            assert spec.rate > 0, "token rate must be positive"
            assert spec.burst >= 1, \
                "burst < 1 can never hold a whole token: nothing would " \
                "ever admit"
        self._specs[spec.tenant] = spec
        if spec.rate is not None:
            self._buckets[spec.tenant] = _Bucket(float(spec.burst), 0.0)
        return spec

    def reset_clock(self) -> None:
        """Restore the virtual-clock-relative state (full token buckets at
        t=0, fair-share accounting) for a fresh serving run. Called by
        `QoSAdmission.prepare`, so one admission object can serve several
        streams — each starting from the same reproducible state — while
        the lifetime `admitted` counters keep accumulating."""
        for tenant, b in self._buckets.items():
            b.tokens, b.last_t = float(self.spec(tenant).burst), 0.0
        self._service.clear()

    def spec(self, tenant: str) -> TenantSpec:
        s = self._specs.get(tenant)
        if s is None:                  # unknown tenants: permissive default
            s = TenantSpec(tenant)
            self._specs[tenant] = s
        return s

    @property
    def tenants(self):
        return sorted(self._specs)

    # --------------------------------------------------------- token bucket
    def earliest_admit(self, tenant: str, t: float) -> float:
        """Earliest virtual time >= t at which a token is available. PURE
        (no bucket mutation): the admission loop may probe the same tenant
        at several candidate times before committing, and a probe must not
        change the answer of the next one."""
        spec = self.spec(tenant)
        b = self._buckets.get(tenant)
        if b is None:
            return t
        tokens = b.tokens if t <= b.last_t else \
            min(float(spec.burst), b.tokens + (t - b.last_t) * spec.rate)
        if tokens >= 1.0:
            return t
        return b.last_t + (1.0 - b.tokens) / spec.rate

    def acquire(self, tenant: str, t: float) -> None:
        """Consume one token at virtual time t (caller must have checked
        `earliest_admit(tenant, t) <= t`)."""
        self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        spec = self.spec(tenant)
        b = self._buckets.get(tenant)
        if b is None:
            return
        if t > b.last_t:
            b.tokens = min(float(spec.burst),
                           b.tokens + (t - b.last_t) * spec.rate)
            b.last_t = t
        assert b.tokens >= 1.0 - 1e-9, \
            f"token bucket underflow for {tenant!r} at t={t}"
        b.tokens = max(b.tokens - 1.0, 0.0)

    # ----------------------------------------------------------- fair share
    def charge(self, tenant: str, service_seconds: float) -> None:
        """Account `service_seconds` of lane time to `tenant`."""
        self._service[tenant] = self._service.get(tenant, 0.0) \
            + max(service_seconds, 0.0)

    def fair_key(self, tenant: str) -> float:
        """Weighted virtual service time — smaller = more underserved."""
        return self._service.get(tenant, 0.0) / self.spec(tenant).weight

    def deadline_for(self, tenant: str, arrival_t: float,
                     deadline: Optional[float]) -> Optional[float]:
        """Explicit arrival deadline, else the tenant's default SLO."""
        if deadline is not None:
            return deadline
        slo = self.spec(tenant).slo
        return None if slo is None else arrival_t + slo

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {t: {"admitted": self._admitted.get(t, 0),
                    "service_seconds": round(self._service.get(t, 0.0), 4),
                    "weight": self.spec(t).weight}
                for t in self.tenants}
