"""Schema-faithful synthetic benchmark databases.

The offline container cannot ship IMDb/StackExchange Parquet dumps, so we
generate databases with the same *shape of hardness*: 21-table JOB-like and
10-table STACK-like schemas, Zipf-skewed foreign keys (breaks the CBO's
independence/uniformity assumptions), correlated predicates, and a fact
table with a `production_year` column so the paper's dynamic evaluation
(IMDb-1950 / IMDb-1980 -> full) filters apply (§VII-B5).

Scale is set so that plan-choice effects dominate: bad join orders produce
million-row intermediates (OOM/timeout territory under the cluster cost
model) while good orders stay in the thousands.

Materialization is spec-driven: `make_db_from_spec` interprets any
`repro_torch.gen.spec.SchemaSpec` (the seeded schema sampler's output), and the
hand-built worlds are thin instances — `JOB_SPEC`/`STACK_SPEC` plus the
same interpreter, bit-identical at fixed seeds to the original inline
builders (pinned by tests/test_gen.py)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.gen.spec import (SchemaSpec, TableSpec, cat, cat2, fk, id_col,
                            spec_rows)
from repro_torch.sql.catalog import Database, Table, analyze


def _zipf_fk(rng, n, n_parent, a=0.8):
    """Foreign keys into 0..n_parent-1 with bounded power-law skew: parent k
    gets weight (k+1)^-a. With a=0.6 the hottest parent draws ~0.5% of all
    rows (popular-movie realism: hub joins blow up under bad orders but a
    good order still finishes), and hub identity is SHARED across fact
    tables referencing the same parent — the cross-table correlation that
    breaks the CBO's independence assumption."""
    w = (np.arange(1, n_parent + 1, dtype=np.float64)) ** (-a)
    w /= w.sum()
    return rng.choice(n_parent, size=n, p=w).astype(np.int64)


def _uniform_fk(rng, n, n_parent):
    return rng.integers(0, n_parent, size=n, dtype=np.int64)


# ------------------------------------------------------ spec interpreter
def _realized_rows(spec: SchemaSpec, t: TableSpec, scale: float,
                   realized: Dict[str, int]) -> int:
    """Row count of `t` after scale + size_with cascades (`realized` maps
    already-materialized tables to their actual row counts)."""
    n = spec_rows(t, scale)
    if t.size_with:
        base = spec_rows(spec.table(t.size_with), scale)
        actual = realized[t.size_with]
        if actual != base:         # a snapshot filter shrank the parent
            n = max(16, int(n * actual / base))
    return n


def _draw_column(col, n: int, rng: np.random.Generator, cols: Dict,
                 tables: Dict[str, Dict],
                 realized: Dict[str, int]) -> np.ndarray:
    """One column's numpy draw — the spec grammar's entire runtime. FK
    domain sizes come from `realized` row counts (spec arithmetic), so a
    draw never needs its parent MATERIALIZED — only `via` gathers read
    parent columns, and validation pins those parents earlier."""
    if col.kind == "id":
        return np.arange(n, dtype=np.int64)
    if col.kind == "cat":
        return rng.integers(col.lo, col.hi, n).astype(np.int64)
    if col.kind == "cat2":
        src = cols[col.src]
        hi = rng.integers(0, col.hi_k, n)
        lo = rng.integers(0, col.lo_k, n)
        return np.where(src > col.threshold, hi, lo).astype(np.int64)
    if col.kind == "fk":
        keys = _zipf_fk(rng, n, realized[col.parent], a=col.a) if col.skew \
            else _uniform_fk(rng, n, realized[col.parent])
        if col.via:
            gathered = tables[col.parent].get(col.via)
            assert gathered is not None, \
                f"via gather {col.parent}.{col.via} not materialized yet"
            return gathered[keys]
        return keys
    raise ValueError(col.kind)


def materialize_table(spec: SchemaSpec, t: TableSpec, n: int,
                      rng: np.random.Generator,
                      tables: Optional[Dict[str, Dict]] = None,
                      realized: Optional[Dict[str, int]] = None
                      ) -> Dict[str, np.ndarray]:
    """All of one table's columns: draws follow the hoist order (columns
    with `order` set first), the returned dict keeps spec column order."""
    cols: Dict[str, np.ndarray] = {c.name: None for c in t.columns}
    hoisted = sorted((c for c in t.columns if c.order is not None),
                     key=lambda c: c.order)
    for c in hoisted + [c for c in t.columns if c.order is None]:
        cols[c.name] = _draw_column(c, n, rng, cols, tables or {},
                                    realized or {})
    return cols


def make_db_from_spec(spec: SchemaSpec, *, scale: float = 1.0, seed: int = 0,
                      rng: Optional[np.random.Generator] = None,
                      overrides: Optional[Dict[str, Dict]] = None,
                      name: Optional[str] = None,
                      analyze_seed: Optional[int] = None) -> Database:
    """Materialize a `SchemaSpec` into a `Database`.

    The draw sequence is table-major/column-minor in spec order, except
    columns with `order` set, which are hoisted to the front (sorted by
    `order`) — `fk` parent sizes come from the spec arithmetic, so a
    hoisted draw never needs an unmaterialized table, only `via` gathers
    do (validated by `spec.assert_valid`). `overrides` supplies
    precomputed column dicts (snapshot-filtered roots): overridden tables
    consume NO draws and downstream `size_with` cascades see their
    realized row count. Passing a live `rng` continues an existing
    stream (the hand-built builders draw their root first, filter, then
    hand the rng over); `analyze_seed` defaults to ``seed + 1`` — the
    hand-built worlds' statistics seed."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    overrides = overrides or {}
    realized: Dict[str, int] = {}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    plan = []                       # (table, column, n) draw steps
    for t in spec.tables:
        if t.name in overrides:
            out[t.name] = dict(overrides[t.name])
            realized[t.name] = len(next(iter(out[t.name].values())))
            continue
        # pre-populate in spec column order: hoisting reorders only the
        # DRAWS below, never where a column lands in the table dict
        out[t.name] = {c.name: None for c in t.columns}
        n = _realized_rows(spec, t, scale, realized)
        realized[t.name] = n
        for c in t.columns:
            plan.append((t.name, c, n))
    hoisted = sorted((s for s in plan if s[1].order is not None),
                     key=lambda s: s[1].order)
    for tname, c, n in hoisted + [s for s in plan if s[1].order is None]:
        out[tname][c.name] = _draw_column(c, n, rng, out[tname], out,
                                          realized)
    db = Database(name=name if name is not None else spec.name,
                  tables={t.name: Table(t.name, out[t.name])
                          for t in spec.tables})
    db.stats = analyze(db, rng=np.random.default_rng(
        seed + 1 if analyze_seed is None else analyze_seed))
    return db


# ------------------------------------------------------ hand-built specs
def _fact(name: str, n: int, *extra, skew: bool = True) -> TableSpec:
    """JOB-like movie-fact table: Zipf movie_id into title + extras,
    shrinking with title under snapshot filters."""
    return TableSpec(name, n, (fk("movie_id", "title", skew=skew),) + extra,
                     size_with="title")


JOB_SPEC = SchemaSpec("job", (
    TableSpec("title", 60_000, (
        id_col(),
        # year drawn FIRST (order=0) even though kind_id precedes it in
        # column order — cat2 skews newer movies to kinds 0/1
        cat2("kind_id", "production_year", 1990, 3, 7),
        dataclasses.replace(cat("production_year", 1900, 2014), order=0))),
    _fact("movie_companies", 80_000,
          fk("company_id", "company_name"), cat("company_type_id", 0, 4)),
    _fact("cast_info", 300_000,
          fk("person_id", "name"), cat("role_id", 0, 12)),
    _fact("movie_info", 150_000, cat("info_type_id", 0, 110)),
    _fact("movie_info_idx", 40_000, cat("info_type_id", 0, 110)),
    _fact("movie_keyword", 120_000, fk("keyword_id", "keyword")),
    _fact("aka_title", 10_000, skew=False),
    _fact("complete_cast", 20_000, cat("subject_id", 0, 4),
          cat("status_id", 0, 4), skew=False),
    _fact("movie_link", 8_000, cat("link_type_id", 0, 18),
          fk("linked_movie_id", "title", skew=False), skew=False),
    TableSpec("name", 40_000, (id_col(), cat("gender", 0, 3))),
    TableSpec("aka_name", 15_000, (fk("person_id", "name"),)),
    TableSpec("person_info", 60_000, (fk("person_id", "name"),
                                      cat("info_type_id", 0, 40))),
    TableSpec("char_name", 20_000, (id_col(),)),
    TableSpec("company_name", 3_000, (id_col(),
                                      cat("country_code", 0, 60))),
    TableSpec("company_type", 4, (id_col(),), fixed=True),
    TableSpec("info_type", 110, (id_col(),), fixed=True),
    TableSpec("keyword", 8_000, (id_col(),)),
    TableSpec("kind_type", 7, (id_col(),), fixed=True),
    TableSpec("role_type", 12, (id_col(),), fixed=True),
    TableSpec("comp_cast_type", 4, (id_col(),), fixed=True),
    TableSpec("link_type", 18, (id_col(),), fixed=True),
))

# title's kind_id is a cat2 over production_year, but the ORIGINAL builder
# drew years/kind in title-order too, so the spec draw sequence matches.
# The one stream quirk the STACK schema carries: question.site_id was
# drawn before every other column (order=0), and answer.site_id is a hub
# gather — a fresh Zipf fk into question whose stored values are the
# question's site (the shared-hub cross-table correlation).
STACK_SPEC = SchemaSpec("stack", (
    TableSpec("site", 40, (id_col(),), fixed=True),
    TableSpec("account", 25_000, (id_col(), cat("website_kind", 0, 5))),
    TableSpec("so_user", 30_000, (id_col(), fk("site_id", "site", a=1.2),
                                  fk("account_id", "account", skew=False),
                                  cat("reputation", 0, 100))),
    TableSpec("question", 80_000, (id_col(),
                                   fk("site_id", "site", a=1.2, order=0),
                                   fk("owner_user_id", "so_user"),
                                   cat("score", -5, 50))),
    TableSpec("answer", 400_000, (fk("question_id", "question", a=0.9),
                                  fk("site_id", "question", via="site_id"),
                                  fk("owner_user_id", "so_user"))),
    TableSpec("tag", 2_000, (id_col(), fk("site_id", "site", a=1.2))),
    TableSpec("tag_question", 500_000, (fk("question_id", "question", a=0.9),
                                        fk("tag_id", "tag"))),
    TableSpec("badge", 200_000, (fk("user_id", "so_user", a=0.9),
                                 fk("site_id", "site", a=1.2),
                                 cat("badge_kind", 0, 40))),
    TableSpec("comment", 300_000, (fk("site_id", "site", a=1.2),
                                   fk("post_id", "question", a=0.9))),
    TableSpec("post_link", 15_000, (fk("question_id", "question"),
                                    fk("related_question_id", "question",
                                       skew=False))),
))


def make_job_like(scale: float = 1.0, seed: int = 0,
                  year_max: Optional[int] = None) -> Database:
    """21-table IMDb-like star/snowflake schema: `JOB_SPEC` through the
    spec interpreter. `year_max` filters the fact-root (and cascades to
    FK tables via size_with) to build IMDb-1950/-1980 snapshots — the
    root is drawn first, filtered and reindexed dense, then passed as an
    override so the remaining draw stream is unchanged."""
    rng = np.random.default_rng(seed)
    overrides = {}
    if year_max is not None:
        tspec = JOB_SPEC.table("title")
        title = materialize_table(JOB_SPEC, tspec,
                                  spec_rows(tspec, scale), rng, {})
        keep = title["production_year"] <= year_max
        title = {k: v[keep] for k, v in title.items()}
        title["id"] = np.arange(int(keep.sum()), dtype=np.int64)
        overrides["title"] = title
    return make_db_from_spec(
        JOB_SPEC, scale=scale, seed=seed, rng=rng, overrides=overrides,
        name=f"job{'' if year_max is None else year_max}")


def delta_rows(table: Table, n: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Fresh rows for a delta-table append, shaped like the table's current
    contents: non-key columns are bootstrap-resampled from the existing
    rows (preserving the Zipf skew and keeping every FK pointing at a live
    parent), while dense `id` primary keys extend past the current max so
    appended dimension rows stay unique."""
    cols: Dict[str, np.ndarray] = {}
    for name, arr in table.columns.items():
        if name == "id":
            start = int(arr.max()) + 1 if len(arr) else 0
            cols[name] = np.arange(start, start + n, dtype=arr.dtype)
        elif len(arr):
            cols[name] = rng.choice(arr, size=n)
        else:
            cols[name] = np.zeros(n, arr.dtype)
    return cols


def make_stack_like(scale: float = 1.0, seed: int = 1) -> Database:
    """10-table StackExchange-like schema: `STACK_SPEC` interpreted."""
    return make_db_from_spec(STACK_SPEC, scale=scale, seed=seed)
