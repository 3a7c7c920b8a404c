"""Persistent per-template plan memory: the serving fast path.

A `PlanEntry` is the best-known re-optimization action sequence for one
(template signature x table-version band): replaying its stored actions
through a resumable `AdaptiveRun` reproduces the winning plan WITHOUT a
single `act_batch` call — a memoized hit removes the query from every
policy batch, which is the host-side win `benchmarks/bench_planmem.py`
prices. The memory is fed from two sides:

  serve ingest   every non-memoized successful completion is a promotion
                 candidate: its action sequence replaces the incumbent
                 only when its observed latency strictly beats the
                 incumbent's best (so the memory monotonically improves
                 under serving traffic alone);
  superopt       `plans.superopt.Superoptimizer` runs deterministic beam
                 search over hot templates on idle completion cadence and
                 calls `install` when a candidate's modeled cost beats
                 the incumbent's.

Staleness is handled by FENCING, not deletion: a delta on a table (the
scheduler's `on_delta` hook) or a re-ANALYZE (the drift controller's
`note_stats_refresh`) fences every entry whose band touches that table.
A fenced entry never serves as a blind replay — `probe` skips it — but
survives as a HINT PRIOR: `prior` still returns it, so the
superoptimizer seeds its beam with the old sequence instead of starting
cold on the new data.

Keying. `template_signature` is purely structural (relations, filters,
join conditions — not the query name), so two arrivals of the same
template hit regardless of how the workload labels them; the band is the
`PlanLedger`-style `(table, version // band_width)` tuple, so a version
bump on any referenced table moves the key off the memoized band even
before the fence lands.

Persistence goes through `repro_torch.checkpoint.Checkpointer`: entries are
JSON in the manifest's `extra` blob (Python's JSON float round-trip is
exact, so restored latency stats are bit-identical — pinned by
tests/test_planmem.py).

Determinism: every decision consumes virtual-clock state and exact
latency comparisons; with the memory attached but empty and ingest off,
completions are bit-identical to a memory-less scheduler (pinned by
tests/test_planmem.py and the property test in tests/test_invariants.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["PlanEntry", "PlanMemory", "template_signature", "band_for"]


def template_signature(query) -> str:
    """Stable structural identity of a query template: relations (alias,
    table, filters) + join conditions, independent of the query's name."""
    rels = tuple((r.alias, r.table,
                  tuple((f.column, f.op, tuple(f.value))
                        for f in r.filters))
                 for r in query.relations)
    conds = tuple((c.left, c.lcol, c.right, c.rcol) for c in query.conds)
    return repr((rels, conds))


def band_for(query, versions: Dict[str, int],
             band_width: int = 1) -> Tuple:
    """The query's table-version band (PlanLedger convention): one
    (table, version // band_width) pair per referenced table, sorted."""
    tables = sorted({r.table for r in query.relations})
    w = max(int(band_width), 1)
    return tuple((t, int(versions.get(t, 0)) // w) for t in tables)


@dataclasses.dataclass
class PlanEntry:
    """Best-known action sequence for one (template, band), with streaming
    latency stats (Welford) over its memoized replays."""
    template: str
    band: Tuple
    actions: Tuple[int, ...]
    decoded: Tuple[str, ...] = ()
    source: str = "serve"              # "serve" | "superopt"
    created_t: float = 0.0
    modeled_cost: float = 0.0          # latency that earned the promotion
    fenced: bool = False
    fence_reason: str = ""
    n_hits: int = 0                    # memoized replays served
    n_obs: int = 0                     # latency observations folded in
    mean: float = 0.0
    m2: float = 0.0
    best: float = float("inf")         # best observed/modeled latency

    def observe(self, latency: float) -> None:
        self.n_obs += 1
        d = latency - self.mean
        self.mean += d / self.n_obs
        self.m2 += d * (latency - self.mean)
        self.best = min(self.best, latency)

    def as_dict(self) -> Dict:
        return {"template": self.template,
                "band": [[t, v] for t, v in self.band],
                "actions": list(self.actions),
                "decoded": list(self.decoded),
                "source": self.source, "created_t": self.created_t,
                "modeled_cost": self.modeled_cost,
                "fenced": self.fenced, "fence_reason": self.fence_reason,
                "n_hits": self.n_hits, "n_obs": self.n_obs,
                "mean": self.mean, "m2": self.m2, "best": self.best}

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanEntry":
        return cls(template=d["template"],
                   band=tuple((t, int(v)) for t, v in d["band"]),
                   actions=tuple(int(a) for a in d["actions"]),
                   decoded=tuple(str(x) for x in d["decoded"]),
                   source=d["source"], created_t=d["created_t"],
                   modeled_cost=d["modeled_cost"], fenced=d["fenced"],
                   fence_reason=d["fence_reason"], n_hits=d["n_hits"],
                   n_obs=d["n_obs"], mean=d["mean"], m2=d["m2"],
                   best=d["best"])


class PlanMemory:
    """Memoized (template x band) -> action-sequence store.

    Attach to a scheduler (directly, via `LaneScheduler(plan_memory=...)`
    or `QueryService(plan_memory=...)`): the scheduler probes it at
    `_start` (a hit replays the stored actions with zero `act_batch`
    calls), its `on_complete` hook folds observed latencies back into
    entry stats and ingest-promotes better serving plans, and its
    `on_delta` hook fences entries whose tables were written."""

    def __init__(self, *, band_width: int = 1, ingest_serving: bool = True):
        self.band_width = max(int(band_width), 1)
        self.ingest_serving = ingest_serving
        self._entries: Dict[Tuple[str, Tuple], PlanEntry] = {}
        self._sched = None
        self.n_probes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_fenced = 0
        self.n_promoted_serve = 0
        self.n_promoted_superopt = 0
        self.n_replay_failures = 0

    # ------------------------------------------------------------- plumbing
    def attach(self, scheduler) -> None:
        self._sched = scheduler
        scheduler.plan_memory = self
        scheduler.on_complete.append(self._on_complete)
        scheduler.on_delta.append(self._on_delta)

    def __len__(self) -> int:
        return len(self._entries)

    def key_for(self, query, versions: Dict[str, int]) -> Tuple[str, Tuple]:
        return (template_signature(query),
                band_for(query, versions, self.band_width))

    def entries(self) -> List[PlanEntry]:
        return [self._entries[k] for k in sorted(self._entries)]

    def _emit(self, kind: str, attrs: Dict, t: Optional[float]) -> None:
        obs = getattr(self._sched, "obs", None) if self._sched is not None \
            else None
        if obs is not None:
            obs.event(kind, attrs, t=t)

    # -------------------------------------------------------------- serving
    def probe(self, query, versions: Dict[str, int]) -> Optional[PlanEntry]:
        """The scheduler's fast-path lookup: the unfenced entry for this
        exact (template, band), or None. Counts a hit/miss."""
        self.n_probes += 1
        e = self._entries.get(self.key_for(query, versions))
        if e is None or e.fenced:
            self.n_misses += 1
            return None
        self.n_hits += 1
        e.n_hits += 1
        return e

    def would_hit(self, query, versions: Dict[str, int]) -> bool:
        """Count-free peek (the QoS ladder's memo-rung check)."""
        e = self._entries.get(self.key_for(query, versions))
        return e is not None and not e.fenced

    def prior(self, query, versions: Dict[str, int]) -> Optional[PlanEntry]:
        """Hint prior for the superoptimizer: the entry for this key even
        when fenced (a stale best sequence still seeds the beam)."""
        return self._entries.get(self.key_for(query, versions))

    # ------------------------------------------------------------ promotion
    def install(self, query, versions: Dict[str, int], actions, *,
                cost: float, source: str = "superopt", decoded=(),
                t: float = 0.0) -> PlanEntry:
        """Promote `actions` as the best-known sequence for this key.
        Replaces any incumbent unconditionally — callers are responsible
        for the beats-the-incumbent check (see `Superoptimizer`)."""
        sig, band = self.key_for(query, versions)
        e = PlanEntry(template=sig, band=band,
                      actions=tuple(int(a) for a in actions),
                      decoded=tuple(str(d) for d in decoded),
                      source=source, created_t=float(t),
                      modeled_cost=float(cost))
        e.observe(float(cost))
        self._entries[(sig, band)] = e
        if source == "superopt":
            self.n_promoted_superopt += 1
        else:
            self.n_promoted_serve += 1
        self._emit("plan_memory_promoted",
                   {"query": query.name, "source": source,
                    "n_actions": len(e.actions),
                    "cost": round(float(cost), 6)}, t=t)
        return e

    # -------------------------------------------------------------- fencing
    def _fence(self, e: PlanEntry, reason: str, t: float) -> None:
        if e.fenced:
            return
        e.fenced = True
        e.fence_reason = reason
        self.n_fenced += 1
        self._emit("plan_memory_fenced",
                   {"reason": reason, "source": e.source,
                    "band": [list(b) for b in e.band]}, t=t)

    def fence_table(self, table: str, reason: str, t: float = 0.0) -> int:
        """Fence every entry whose band references `table` (its stats
        moved: blind replay is no longer safe, hint-prior status remains).
        Returns how many entries were newly fenced."""
        before = self.n_fenced
        for e in self._entries.values():
            if not e.fenced and any(tbl == table for tbl, _ in e.band):
                self._fence(e, reason, t)
        return self.n_fenced - before

    def note_stats_refresh(self, tables, t: float = 0.0) -> int:
        """Drift-controller seam: a re-ANALYZE rewrote these tables'
        statistics under the entries' feet."""
        return sum(self.fence_table(tbl, "re-analyze", t)
                   for tbl in sorted(set(tables)))

    # ----------------------------------------------------------- scheduler
    def _on_delta(self, t_apply: float, delta) -> None:
        self.fence_table(delta.table, "delta", t_apply)

    def _on_complete(self, comp) -> None:
        versions = self._sched.db.versions
        sig, band = self.key_for(comp.query, versions)
        e = self._entries.get((sig, band))
        if getattr(comp, "memoized", False):
            if e is None:
                return                 # fenced/replaced mid-flight
            e.observe(comp.result.latency)
            if comp.result.failed:
                # a replayed plan that fails on its own band is stale
                # evidence the band key missed (e.g. in-band growth):
                # demote it to hint-prior immediately
                self.n_replay_failures += 1
                self._fence(e, f"replay-failed:{comp.failure_kind}",
                            comp.finish_t)
            return
        if not self.ingest_serving or comp.result.failed:
            return
        latency = comp.result.latency
        if e is None or e.fenced or latency < e.best:
            self.install(comp.query, versions, tuple(comp.traj.actions),
                         cost=latency, source="serve",
                         decoded=tuple(str(d) for d in comp.traj.decoded),
                         t=comp.finish_t)

    def note_latency(self, query, versions: Dict[str, int],
                     latency: float) -> bool:
        """Harvester feedback seam: fold an observed (non-memoized, e.g.
        agent-served) latency for this key into the entry's streaming
        stats WITHOUT letting it claim the `best` slot — only memoized
        replays and promotions move `best`, so serving noise widens the
        entry's variance instead of silently raising its bar."""
        e = self._entries.get(self.key_for(query, versions))
        if e is None:
            return False
        e.n_obs += 1
        d = latency - e.mean
        e.mean += d / e.n_obs
        e.m2 += d * (latency - e.mean)
        return True

    # ----------------------------------------------------------- accounting
    def stats(self) -> Dict:
        return {"entries": len(self._entries),
                "fenced_entries": sum(e.fenced
                                      for e in self._entries.values()),
                "probes": self.n_probes, "hits": self.n_hits,
                "misses": self.n_misses, "fenced": self.n_fenced,
                "promoted_serve": self.n_promoted_serve,
                "promoted_superopt": self.n_promoted_superopt,
                "replay_failures": self.n_replay_failures}

    def reset_stats(self, *, clear_entries: bool = False) -> None:
        self.n_probes = self.n_hits = self.n_misses = 0
        self.n_fenced = self.n_replay_failures = 0
        self.n_promoted_serve = self.n_promoted_superopt = 0
        if clear_entries:
            self._entries.clear()

    # ---------------------------------------------------------- persistence
    def to_dict(self) -> Dict:
        return {"band_width": self.band_width,
                "ingest_serving": self.ingest_serving,
                "entries": [self._entries[k].as_dict()
                            for k in sorted(self._entries)]}

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanMemory":
        mem = cls(band_width=d["band_width"],
                  ingest_serving=d["ingest_serving"])
        for ed in d["entries"]:
            e = PlanEntry.from_dict(ed)
            mem._entries[(e.template, e.band)] = e
        return mem

    def save(self, directory, step: Optional[int] = None) -> int:
        """Persist entries through the manifest-fenced checkpointer (the
        same store policy versions go through). JSON float round-trip is
        exact, so save->load restores entries bit-identically."""
        from repro_torch.checkpoint import Checkpointer
        ck = Checkpointer(directory)
        step = ck.next_step() if step is None else step
        assert ck.save(step, {}, extra={"plan_memory": self.to_dict()}), \
            f"step {step} already exists under {directory}"
        return step

    @classmethod
    def load(cls, directory, step: Optional[int] = None) -> "PlanMemory":
        from repro_torch.checkpoint import Checkpointer
        _, _, extra = Checkpointer(directory).restore({}, step=step)
        return cls.from_dict(extra["plan_memory"])
