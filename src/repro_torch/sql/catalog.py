"""Catalog: tables as column arrays + (possibly stale) optimizer statistics.

The engine executes on exact numpy columns; the CBO sees only `Stats`
(row counts + per-column distinct counts estimated FROM A SAMPLE, optionally
computed on an older version of the data) — reproducing the paper's central
premise that pre-execution estimates are unreliable while runtime
cardinalities are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

ROW_OVERHEAD_BYTES = 8          # per column per row (int64 columns)


@dataclasses.dataclass
class Table:
    name: str
    columns: Dict[str, np.ndarray]

    @property
    def nrows(self) -> int:
        return 0 if not self.columns else len(next(iter(self.columns.values())))

    @property
    def ncols(self) -> int:
        return len(self.columns)

    def bytes(self) -> int:
        return self.nrows * self.ncols * ROW_OVERHEAD_BYTES


@dataclasses.dataclass
class ColumnStats:
    n_distinct: float
    min_val: float
    max_val: float


@dataclasses.dataclass
class TableStats:
    nrows: float
    columns: Dict[str, ColumnStats]


@dataclasses.dataclass
class Stats:
    """What the CBO believes. Built by `analyze(db, sample, noise)`; can be
    built from an old snapshot for the dynamic-evaluation experiments.
    `versions` records each table's data version AT ANALYZE TIME, so the
    drift detector can measure catalog lag even for staleness that
    predates its attachment (None for hand-built snapshots: lag is then
    baselined at attach)."""
    tables: Dict[str, TableStats]
    versions: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class Database:
    name: str
    tables: Dict[str, Table]
    stats: Optional[Stats] = None
    # per-table data versions: bumped by delta application (serve.deltas);
    # stage-cache signatures embed these tags, so a bump invalidates every
    # cached stage derived from the old data in O(1). `stats` is NOT
    # refreshed on a bump — stale optimizer statistics over fresh data is
    # the paper's dynamic-evaluation premise.
    versions: Dict[str, int] = dataclasses.field(default_factory=dict)

    def table(self, name: str) -> Table:
        return self.tables[name]

    def table_version(self, name: str) -> int:
        return self.versions.get(name, 0)

    def bump_version(self, name: str) -> int:
        """Record that `name`'s data changed; notifies an attached stage
        cache (if any) so invalidations are observable in its counters."""
        self.versions[name] = self.versions.get(name, 0) + 1
        cache = getattr(self, "_stage_cache", None)
        if cache is not None and hasattr(cache, "note_invalidation"):
            cache.note_invalidation(name)
        return self.versions[name]


def analyze_table(db: Database, name: str, sample_frac: float = 0.05,
                  rng: Optional[np.random.Generator] = None) -> TableStats:
    """ANALYZE one table: sample-based statistics (distinct counts via
    sample-scale-up — systematically wrong under skew, as in real systems).
    The incremental unit behind `analyze`; the drift control plane
    (`serve.drift`) calls it per drifted table instead of re-scanning the
    whole catalog."""
    rng = rng if rng is not None else np.random.default_rng(0)
    t = db.table(name)
    cols: Dict[str, ColumnStats] = {}
    n = t.nrows
    k = max(32, int(n * sample_frac))
    idx = rng.integers(0, max(n, 1), size=min(k, n)) if n else np.zeros(0, np.int64)
    for cname, arr in t.columns.items():
        s = arr[idx] if n else arr
        d_sample = len(np.unique(s)) if len(s) else 0
        # first-order jackknife scale-up (biased low under Zipf skew)
        frac = len(s) / max(n, 1)
        nd = d_sample / max(frac ** 0.5, 1e-9) if n else 0
        nd = min(nd, n)
        cols[cname] = ColumnStats(
            n_distinct=max(nd, 1.0),
            min_val=float(arr.min()) if n else 0.0,
            max_val=float(arr.max()) if n else 0.0)
    return TableStats(nrows=float(n), columns=cols)


def analyze(db: Database, sample_frac: float = 0.05,
            rng: Optional[np.random.Generator] = None) -> Stats:
    """ANALYZE TABLE over the whole catalog (one shared rng, so the draw
    sequence is unchanged from the original single-pass implementation);
    stamps the data versions the statistics were taken at."""
    rng = rng if rng is not None else np.random.default_rng(0)
    return Stats(tables={name: analyze_table(db, name, sample_frac, rng)
                         for name in db.tables},
                 versions={name: db.table_version(name)
                           for name in db.tables})
