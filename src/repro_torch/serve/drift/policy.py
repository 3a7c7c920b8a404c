"""Stats-refresh policies: when is re-ANALYZE worth its cost?

The paper keeps statistics deliberately stale and defers correction to
runtime; classical practice re-ANALYZEs on a cadence and trusts the
optimizer. `RefreshPolicy` makes that a pluggable, benchmarked decision
(`benchmarks/bench_drift.py` sweeps all four kinds against online
adaptation):

  never      today's baseline: statistics are written once and never
             touched — the scheduler path is bit-identical to a run with
             no drift control plane at all (pinned by tests).
  always     re-ANALYZE every table whose data version moved, as soon as
             the detector sees the lag — classical eager maintenance;
             maximal stats quality, maximal (modeled + wall) cost.
  threshold  re-ANALYZE a table only once its fused drift score crosses
             `threshold` — catalog lag alone does not trigger a scan
             until data movement or execution evidence makes it matter.
  budgeted   threshold, plus a hard ceiling on cumulative MODELED
             re-ANALYZE cost (`budget_s`, priced by the cluster model so
             decisions stay bit-deterministic — wall time is reported,
             never consulted): highest-score tables first; a table whose
             cost would bust the ceiling is skipped, and cheaper
             lower-score tables that still fit are taken.

`min_interval` (virtual seconds) floors how often any single table may
be re-ANALYZEd under every kind except "never" — the backstop against a
churn-heavy stream turning "always" into a scan storm.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.serve.drift.detector import TableDrift

__all__ = ["RefreshPolicy", "RefreshDecision"]

KINDS = ("never", "always", "threshold", "budgeted")


@dataclasses.dataclass(frozen=True)
class RefreshDecision:
    tables: tuple                  # to re-ANALYZE, highest score first
    modeled_cost_s: float          # deterministic price of this decision
    reason: str = ""


_NOOP = RefreshDecision((), 0.0, "")


class RefreshPolicy:
    def __init__(self, kind: str = "threshold", *, threshold: float = 1.0,
                 budget_s: Optional[float] = None,
                 min_interval: float = 0.0):
        assert kind in KINDS, f"kind must be one of {KINDS}, got {kind!r}"
        if kind == "budgeted":
            assert budget_s is not None, "budgeted policy needs budget_s"
        self.kind = kind
        self.threshold = threshold
        self.budget_s = budget_s
        self.min_interval = min_interval
        self.spent_modeled_s = 0.0         # charged by the controller
        self.last_refresh: Dict[str, float] = {}   # table -> virtual time
        self.n_decisions = 0

    # ------------------------------------------------------------- deciding
    def _eligible(self, d: TableDrift, now: float) -> bool:
        if not d.drifted:
            return False
        last = self.last_refresh.get(d.table)
        if last is not None and now - last < self.min_interval:
            return False
        if self.kind == "always":
            return True
        return d.score >= self.threshold

    def decide(self, drifts: Dict[str, TableDrift], now: float,
               cost_fn: Callable[[str], float]) -> RefreshDecision:
        """Pick the tables to re-ANALYZE at virtual time `now`. `cost_fn`
        prices one table's ANALYZE in MODELED seconds (cluster scan model
        over the sampled bytes) — the only cost the budgeted policy
        consults, so the decision is a pure function of the stream.

        The budget is RESERVED here, not when the barrier task later
        runs: a second decision taken while the first task still waits
        for lanes to drain must already see its cost, or two
        decided-but-unrun refreshes could together overshoot the hard
        ceiling."""
        if self.kind == "never":
            return _NOOP
        self.n_decisions += 1
        cands = sorted((d for d in drifts.values()
                        if self._eligible(d, now)),
                       key=lambda d: (-d.score, d.table))
        if not cands:
            return _NOOP
        picked: List[str] = []
        cost = 0.0
        for d in cands:
            c = cost_fn(d.table)
            if self.kind == "budgeted" and \
                    self.spent_modeled_s + cost + c > self.budget_s:
                continue               # cheaper lower-score table may fit
            picked.append(d.table)
            cost += c
        if not picked:
            return _NOOP
        self.spent_modeled_s += cost   # reserve against the ceiling NOW
        reason = {"always": "version lag",
                  "threshold": f"score >= {self.threshold}",
                  "budgeted": f"score >= {self.threshold} within "
                              f"{self.budget_s}s budget"}[self.kind]
        return RefreshDecision(tuple(picked), cost, reason)

    # ------------------------------------------------------------ lifecycle
    def note_refreshed(self, table: str, now: float) -> None:
        """Record the refresh time for `min_interval` (the modeled cost
        was already reserved by the `decide` that picked the table)."""
        self.last_refresh[table] = now

    def stats(self) -> Dict[str, float]:
        return {"kind": self.kind, "decisions": self.n_decisions,
                "spent_modeled_s": round(self.spent_modeled_s, 4),
                "tables_refreshed": len(self.last_refresh)}
