"""Runtime stage-result cache: LRU under a byte budget + O(1) invalidation.

Replaces the executor's original `db._stage_cache` dict, which dropped the
ENTIRE cache whenever the byte budget overflowed. Entries are keyed by the
stage's structural signature — which, since the signatures embed each base
table's version tag (see `Database.table_version`), makes invalidation O(1)
on update: bumping a table's version means every signature derived from the
old data simply never matches again. Stale entries are not scanned or
eagerly dropped (that would be O(entries)); they age out through normal LRU
eviction.

Only row SETS are cached. Latency, shuffle accounting and OOM checks are
always recomputed by the executor against the current run's cluster, so
results are bit-identical with the cache off — the invariant the
invalidation tests pin down.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Hashable, Optional


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0          # table-version bumps observed

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate, 4)}

    def reset(self) -> None:
        self.hits = self.misses = self.evictions = self.invalidations = 0


class StageCache:
    """Byte-budgeted LRU over opaque stage entries.

    The budget is on BYTES, not entry count: materialized stages can hold
    millions of rows, so an entry cap alone would let the host grow without
    limit over a long serving run. Oversized entries (> max_entry_bytes)
    are never admitted — huge stages are not worth pinning.
    """

    def __init__(self, max_bytes: int = 256 * 1024 * 1024,
                 max_entry_bytes: int = 32 * 1024 * 1024):
        self.max_bytes = max_bytes
        self.max_entry_bytes = max_entry_bytes
        self.bytes = 0
        self.stats = CacheStats()
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sig) -> bool:
        return sig in self._entries

    def get(self, sig) -> Optional[object]:
        slot = self._entries.get(sig)
        if slot is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(sig)
        self.stats.hits += 1
        return slot[0]

    def put(self, sig, entry, nbytes: int) -> bool:
        """Insert (or refresh) `entry`; evicts LRU entries until it fits.
        Returns False when the entry is too large to ever cache."""
        if nbytes > self.max_entry_bytes or nbytes > self.max_bytes:
            return False
        old = self._entries.pop(sig, None)
        if old is not None:
            self.bytes -= old[1]
        while self._entries and self.bytes + nbytes > self.max_bytes:
            _, (_, evicted_bytes) = self._entries.popitem(last=False)
            self.bytes -= evicted_bytes
            self.stats.evictions += 1
        self._entries[sig] = (entry, nbytes)
        self.bytes += nbytes
        return True

    def note_invalidation(self, table: str) -> None:
        """Called (via `Database.bump_version`) when a table mutates. O(1):
        the version tag inside every signature does the actual fencing."""
        self.stats.invalidations += 1

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0

    def reset_stats(self) -> None:
        """Zero the counters WITHOUT touching resident entries: the seam
        that makes consecutive `QueryService` runs sharing one cache
        independently measurable (counters otherwise accumulate across
        runs and the second run's hit rate is polluted by the first's)."""
        self.stats.reset()


class PartitionedStageCache(StageCache):
    """Per-tenant cache partitions under one roof.

    Each tenant evicts ONLY against its own byte budget, so a
    noisy-neighbor tenant flooding the cache can never push out a
    well-behaved tenant's entries — the isolation property
    `benchmarks/bench_qos.py` pins down. Invalidation stays O(1) and
    GLOBAL: signatures embed per-table version tags, so one delta fences
    every tenant's stale entries at once without scanning any partition
    (`note_invalidation` only bumps the shared counter).

    The object itself IS the default partition (a plain `StageCache`
    with `default_bytes`), so code that treats `db._stage_cache` as a
    flat cache — `sql.executor.Executor`'s auto-attach, direct
    `run_adaptive` calls — keeps working unchanged and lands in the
    default tenant's budget. The scheduler routes each lane to
    `partition(arrival.tenant)` explicitly. Only tenants with a
    CONFIGURED budget get their own partition; unknown tenant ids share
    the default one, so total cache memory stays bounded by
    sum(budgets) + default_bytes no matter how many distinct ids a
    stream carries.
    """

    def __init__(self, default_bytes: int = 256 * 1024 * 1024,
                 max_entry_bytes: int = 32 * 1024 * 1024,
                 budgets: Optional[Dict[str, int]] = None):
        budgets = dict(budgets or {})
        # the object IS the "default" partition, so an explicit budget for
        # the default tenant must size THIS cache, not a side partition
        super().__init__(budgets.get("default", default_bytes),
                         max_entry_bytes)
        self.default_bytes = default_bytes
        self._budgets = budgets
        self._parts: Dict[str, StageCache] = {}

    def partition(self, tenant: Optional[str]) -> StageCache:
        """The `StageCache` serving `tenant`: its own partition (created
        lazily under its configured budget) for budgeted tenants, the
        default partition for everyone else."""
        if tenant is None or tenant == "default":
            return self
        p = self._parts.get(tenant)
        if p is None:
            budget = self._budgets.get(tenant)
            if budget is None:         # unbudgeted ids share the default
                return self
            p = self._parts[tenant] = StageCache(budget,
                                                 self.max_entry_bytes)
        return p

    def partitions(self) -> Dict[str, StageCache]:
        out = {"default": self}
        out.update(self._parts)
        return out

    # note_invalidation: the base method already only bumps the shared
    # counter — O(1) across ALL partitions, the version tags inside every
    # signature do the fencing

    def clear(self) -> None:
        super().clear()
        for p in self._parts.values():
            p.clear()

    def reset_stats(self) -> None:
        super().reset_stats()
        for p in self._parts.values():
            p.reset_stats()

    def stats_by_tenant(self) -> Dict[str, Dict[str, float]]:
        return {t: p.stats.as_dict() for t, p in self.partitions().items()}

    def aggregate_stats(self) -> Dict[str, float]:
        """Counters summed over every partition (invalidations are shared,
        counted once), shaped like `CacheStats.as_dict()`."""
        agg = CacheStats(invalidations=self.stats.invalidations)
        for p in self.partitions().values():
            agg.hits += p.stats.hits
            agg.misses += p.stats.misses
            agg.evictions += p.stats.evictions
        return agg.as_dict()
