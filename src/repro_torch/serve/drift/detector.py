"""Drift detection: per-table staleness as a measured, managed quantity.

The paper's premise is that optimizer statistics go stale while data
changes; everything downstream of `analyze()` treats that staleness as a
fixed fact. This module makes it a NUMBER. Per base table the detector
fuses three signal families, each observable on the serving path for
free:

  catalog lag     `Database.versions` bumps since the table's stats were
                  last ANALYZEd, and |ln(live rows / stats rows)| — how
                  far the data moved while the optimizer wasn't looking.
                  Both are O(1) reads; no scan, no sample.

  latency regret  harvested execution feedback (the original `ReplayBuffer`
                  keeps per-template best latencies): completions that
                  run far above their template's best are evidence the
                  plans chosen for this data are no longer the right
                  ones. Attributed to every base table the query touches.

  predictor error relative |predicted − actual| latency error of the QoS
                  `LatencyPredictor`: the learned model of the workload
                  disagreeing with reality is drift made legible even
                  when regret is masked (e.g. every execution of a
                  template degraded together).

A table with ZERO version lag scores 0.0 by construction — its data did
not change, so its statistics are not stale, and regret/error on it is a
policy problem, not a stats problem. For drifted tables the catalog-lag
magnitude is amplified by the execution evidence:

  score = (w_version·lag + w_rows·|ln(live/stats)|)
          · (1 + w_regret·regret̄ + w_pred·err̄)

with regret̄/err̄ windowed means over the last `window` completions
touching the table (capped so one 300s timeout cannot saturate the
score). Everything is a pure function of observed completions, so two
identical runs produce identical scores — pinned by tests/test_drift.py.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = ["TableDrift", "DriftDetector"]


@dataclasses.dataclass(frozen=True)
class TableDrift:
    """One table's staleness assessment at scoring time."""
    table: str
    version_lag: int        # data-version bumps since last ANALYZE
    rows_ratio: float       # live rows / stats rows (1.0 = in sync)
    regret: float           # windowed mean latency regret (capped)
    pred_err: float         # windowed mean relative predictor error
    score: float

    @property
    def drifted(self) -> bool:
        return self.version_lag > 0


class DriftDetector:
    def __init__(self, *, window: int = 32, w_version: float = 0.25,
                 w_rows: float = 1.0, w_regret: float = 1.0,
                 w_pred: float = 1.0, regret_cap: float = 4.0,
                 err_cap: float = 4.0):
        self.window = window
        self.w_version, self.w_rows = w_version, w_rows
        self.w_regret, self.w_pred = w_regret, w_pred
        self.regret_cap, self.err_cap = regret_cap, err_cap
        # per-table data version at the last ANALYZE of that table
        self.stats_versions: Dict[str, int] = {}
        self._regret: Dict[str, deque] = {}
        self._pred_err: Dict[str, deque] = {}
        self.n_observed = 0

    # ------------------------------------------------------------ lifecycle
    def snapshot(self, db) -> None:
        """Baseline the catalog's per-table versions (call once when the
        controller attaches). `analyze()` stamps the versions its
        statistics were taken at, so staleness that PREDATES attachment
        is still measured as lag; hand-built Stats without a stamp fall
        back to 'in sync as of now'."""
        tables = db.stats.tables if db.stats is not None else db.tables
        stamped = getattr(db.stats, "versions", None) or {}
        for t in tables:
            self.stats_versions.setdefault(
                t, stamped.get(t, db.table_version(t)))

    def note_refreshed(self, table: str, version: int) -> None:
        """A re-ANALYZE of `table` landed at data version `version`: its
        catalog lag returns to zero and its execution-evidence windows
        restart (pre-refresh regret described plans chosen under the OLD
        statistics)."""
        self.stats_versions[table] = version
        self._regret.pop(table, None)
        self._pred_err.pop(table, None)

    # ------------------------------------------------------------ observing
    def observe(self, tables: Iterable[str], *,
                regret: Optional[float] = None,
                pred_err: Optional[float] = None) -> None:
        """Fold one completion's execution evidence into every base table
        the query touched."""
        self.n_observed += 1
        for t in tables:
            if regret is not None:
                self._regret.setdefault(
                    t, deque(maxlen=self.window)).append(regret)
            if pred_err is not None:
                self._pred_err.setdefault(
                    t, deque(maxlen=self.window)).append(pred_err)

    # -------------------------------------------------------------- scoring
    def _mean(self, dq: Optional[deque], cap: float) -> float:
        if not dq:
            return 0.0
        return min(sum(dq) / len(dq), cap)

    def score_table(self, db, table: str) -> TableDrift:
        lag = db.table_version(table) - self.stats_versions.get(table, 0)
        live = db.table(table).nrows
        ts = None if db.stats is None else db.stats.tables.get(table)
        believed = live if ts is None else ts.nrows
        ratio = (live / believed) if believed else math.inf
        regret = self._mean(self._regret.get(table), self.regret_cap)
        err = self._mean(self._pred_err.get(table), self.err_cap)
        if lag <= 0:
            score = 0.0            # data unchanged => stats are not stale
        else:
            # a table emptied or grown from nothing maxes the magnitude
            rows_drift = abs(math.log(ratio)) if 0.0 < ratio < math.inf \
                else 10.0
            score = (self.w_version * lag + self.w_rows * rows_drift) * \
                (1.0 + self.w_regret * regret + self.w_pred * err)
        return TableDrift(table, lag, round(ratio, 4) if ratio != math.inf
                          else math.inf, regret, err, score)

    def score(self, db) -> Dict[str, TableDrift]:
        """Score every table the catalog has statistics on, in sorted
        name order (deterministic iteration for every consumer)."""
        tables = db.stats.tables if db.stats is not None else db.tables
        return {t: self.score_table(db, t) for t in sorted(tables)}

    def top(self, db, k: int = 3) -> List[TableDrift]:
        ds = sorted(self.score(db).values(),
                    key=lambda d: (-d.score, d.table))
        return ds[:k]

    def stats(self) -> Dict[str, float]:
        return {"observed": self.n_observed,
                "tables_tracked": len(self.stats_versions)}
