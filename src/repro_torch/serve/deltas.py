"""Delta-table dynamic workloads: append/delete batches against the live
database.

A `DeltaBatch` mutates one table in place (appending bootstrap-resampled
rows and/or deleting a random row fraction) and bumps the table's version
tag via `Database.bump_version`. Because stage-cache signatures embed those
tags, every cached stage derived from the old contents stops matching the
moment the delta lands — a stale entry served after the delta would return
provably wrong rows, which is exactly what the invalidation tests assert
never happens.

Optimizer statistics (`db.stats`) are deliberately NOT refreshed: queries
after a delta plan with stale estimates over fresh data, reproducing the
paper's dynamic-evaluation setting (and LIMAO's data-drift motivation).

Deletes are only generated for fact tables (no dense `id` primary key), so
foreign keys in the rest of the schema never dangle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.sql import datagen
from repro_torch.sql.catalog import Database


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One update batch against `table`: `n_append` bootstrap-resampled new
    rows, then `delete_frac` of the (post-append) rows removed."""
    table: str
    n_append: int = 0
    delete_frac: float = 0.0
    seed: int = 0

    def __str__(self) -> str:
        return (f"delta({self.table}: +{self.n_append} rows, "
                f"-{self.delete_frac:.0%})")


def apply_delta(db: Database, delta: DeltaBatch) -> Dict[str, int]:
    """Mutate the table in place and bump its version. Returns counts."""
    t = db.table(delta.table)
    rng = np.random.default_rng(delta.seed)
    appended = deleted = 0
    if delta.n_append > 0:
        new = datagen.delta_rows(t, delta.n_append, rng)
        t.columns = {k: np.concatenate([v, new[k]])
                     for k, v in t.columns.items()}
        appended = delta.n_append
    if delta.delete_frac > 0.0 and t.nrows:
        keep = rng.random(t.nrows) >= delta.delete_frac
        deleted = int(t.nrows - keep.sum())
        if deleted:
            t.columns = {k: v[keep] for k, v in t.columns.items()}
    db.bump_version(delta.table)
    return {"appended": appended, "deleted": deleted}


# fact tables (no dense `id` PK referenced elsewhere): safe delete targets
FACT_TABLES = {
    "job": ("movie_info", "movie_keyword", "cast_info", "movie_companies",
            "movie_info_idx"),
    "extjob": ("movie_info", "movie_keyword", "cast_info", "movie_companies",
               "movie_info_idx"),
    "stack": ("answer", "tag_question", "comment", "badge"),
}


def make_delta(db: Database, tables: Sequence[str], i: int, *,
               n_append: int, delete_frac: float = 0.0,
               seed: int = 0) -> DeltaBatch:
    """The i-th delta of a stream: round-robin over `tables`."""
    return DeltaBatch(tables[i % len(tables)], n_append=n_append,
                      delete_frac=delete_frac, seed=seed + i)
