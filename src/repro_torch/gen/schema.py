"""SchemaSampler: seeded random FK-DAG schemas in three families.

Each family mirrors a real analytic shape (and one of the hand-built
worlds), so the serve/learn stack meets the same *kinds* of correlation
it trains on — at different arities, skews and sizes:

  star       2-4 fact tables over a shared rim of dims (JOB-like): facts
             carry Zipf fks whose hub identity is SHARED across facts
             into the same dim, plus optional cat2 intra-table
             correlations.
  snowflake  dims are themselves normalized into root -> mid chains, so
             join trees have depth >2 and the sampler's templates grow
             chain-shaped (ExtJOB's link-chains).
  person     two entity hubs (person/item) with activity satellites and
             a `via`-gathered hub key (STACK's answer.site_id =
             question.site_id[fk]) — the cross-table hub correlation
             that breaks per-table independence assumptions.

`sample_schema(seed)` is a pure function of its arguments: same seed,
same `SchemaSpec`, bit-for-bit (pinned by tests/test_gen.py). Every
sampled spec passes `spec.assert_valid` BY CONSTRUCTION: tables are
emitted parents-first, so the FK graph is acyclic and `via` parents are
always materialized earlier; facts/satellites never carry a dense id, so
`delete_safe_tables` is non-empty and the stream sampler always has a
legal delete target.

To add a family: write a `_family(rng) -> List[TableSpec]` builder that
(1) emits parents before children, (2) gives every fk parent a dense id,
(3) leaves at least one childless, id-free table, then register it in
`FAMILIES`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.gen.spec import (ColumnSpec, SchemaSpec, TableSpec, assert_valid,
                            cat, cat2, fk, id_col, join_edges)

__all__ = ["FAMILIES", "sample_schema"]

FAMILIES = ("star", "snowflake", "person")


# ------------------------------------------------------------ draw helpers
def _zipf_a(rng) -> float:
    """Zipf exponent for a skewed fk; the hand-built worlds span 0.8-1.2."""
    return round(float(rng.uniform(0.6, 1.3)), 2)


def _narrow(rng, name: str) -> ColumnSpec:
    """IN-filterable categorical: small domain like role_id/badge_kind."""
    return cat(name, 0, int(rng.integers(3, 60)))


def _wide(rng, name: str) -> ColumnSpec:
    """Range-filterable ordinal: wide domain like production_year/score."""
    lo = int(rng.integers(0, 1000))
    return cat(name, lo, lo + int(rng.integers(200, 2000)))


def _maybe_cat2(rng, cols: List[ColumnSpec], p: float = 0.4) -> None:
    """With prob p, append a two-regime categorical correlated with the
    last cat column (the title.kind_id pattern) — src precedes, so the
    spec stays valid without hoisting."""
    srcs = [c for c in cols if c.kind == "cat"]
    if srcs and rng.random() < p:
        src = srcs[-1]
        thr = int((src.lo + src.hi) // 2)
        cols.append(cat2("mode", src.name, thr,
                         int(rng.integers(2, 5)), int(rng.integers(4, 10))))


def _fact_fks(rng, parents: List[str], n_min: int = 1) -> List[ColumnSpec]:
    """Fk columns into a random subset of `parents` (>= n_min, unique)."""
    k = int(rng.integers(n_min, len(parents) + 1))
    picks = list(rng.choice(len(parents), size=k, replace=False))
    cols = []
    for i in picks:
        skew = bool(rng.random() < 0.75)
        cols.append(fk(f"{parents[i]}_id", parents[i],
                       a=_zipf_a(rng), skew=skew))
    return cols


# ---------------------------------------------------------------- families
def _star(rng) -> List[TableSpec]:
    tables: List[TableSpec] = []
    n_enum = int(rng.integers(1, 3))
    enums = [f"et{i}" for i in range(n_enum)]
    for name in enums:
        tables.append(TableSpec(name, int(rng.integers(4, 24)),
                                (id_col(),), fixed=True))
    n_dims = int(rng.integers(2, 5))
    dims = [f"dim{i}" for i in range(n_dims)]
    for name in dims:
        cols = [id_col(), _narrow(rng, "k0")]
        if rng.random() < 0.5:
            cols.append(_wide(rng, "ts"))
        tables.append(TableSpec(name, int(rng.integers(1000, 8000)),
                                tuple(cols)))
    n_facts = int(rng.integers(2, 5))
    for i in range(n_facts):
        # every fact references dim0 — the shared hub that (a) keeps the
        # join graph connected and (b) gives all facts the SAME Zipf hub
        # rows; dim i % n_dims is also guaranteed so dims get coverage
        anchor = dims[i % n_dims]
        cols = [fk(f"{anchor}_id", anchor, a=_zipf_a(rng))]
        if anchor != dims[0]:
            cols.append(fk(f"{dims[0]}_id", dims[0], a=_zipf_a(rng)))
        others = [d for d in dims if d != anchor and d != dims[0]]
        if others:
            cols += _fact_fks(rng, others, n_min=0)
        if rng.random() < 0.7:
            e = enums[int(rng.integers(n_enum))]
            cols.append(fk(f"{e}_id", e, skew=False))
        cols.append(_narrow(rng, "f0"))
        if rng.random() < 0.5:
            cols.append(_wide(rng, "f1"))
        _maybe_cat2(rng, cols)
        tables.append(TableSpec(f"fact{i}", int(rng.integers(20_000, 80_000)),
                                tuple(cols)))
    return tables


def _snowflake(rng) -> List[TableSpec]:
    tables: List[TableSpec] = []
    n_roots = int(rng.integers(1, 3))
    roots = [f"root{i}" for i in range(n_roots)]
    for name in roots:
        tables.append(TableSpec(name, int(rng.integers(300, 2000)),
                                (id_col(), _narrow(rng, "k0"))))
    n_mids = int(rng.integers(2, 5))
    mids = [f"dim{i}" for i in range(n_mids)]
    for i, name in enumerate(mids):
        # every mid chains to a root — join trees get depth >= 3
        root = roots[i % n_roots]
        cols = [id_col(), fk(f"{root}_id", root, a=_zipf_a(rng),
                             skew=bool(rng.random() < 0.6)),
                _narrow(rng, "k0")]
        if rng.random() < 0.4:
            cols.append(_wide(rng, "ts"))
        tables.append(TableSpec(name, int(rng.integers(2000, 12_000)),
                                tuple(cols)))
    n_facts = int(rng.integers(2, 4))
    for i in range(n_facts):
        # mids[0] is the shared hub every fact references (connectivity +
        # shared Zipf rows); the rotating anchor spreads mid coverage
        anchor = mids[i % n_mids]
        cols = [fk(f"{anchor}_id", anchor, a=_zipf_a(rng))]
        if anchor != mids[0]:
            cols.append(fk(f"{mids[0]}_id", mids[0], a=_zipf_a(rng)))
        others = [d for d in mids if d != anchor and d != mids[0]]
        if others:
            cols += _fact_fks(rng, others, n_min=0)
        if rng.random() < 0.5:    # occasional shortcut edge straight to a root
            r = roots[int(rng.integers(n_roots))]
            cols.append(fk(f"{r}_id", r, skew=False))
        cols.append(_narrow(rng, "f0"))
        _maybe_cat2(rng, cols)
        tables.append(TableSpec(f"fact{i}", int(rng.integers(20_000, 70_000)),
                                tuple(cols)))
    return tables


def _person(rng) -> List[TableSpec]:
    tables: List[TableSpec] = []
    # the site-like hub: tiny, fixed, heavily Zipf-referenced
    hub_n = int(rng.integers(16, 64))
    tables.append(TableSpec("hub", hub_n, (id_col(),), fixed=True))
    tables.append(TableSpec("person", int(rng.integers(4000, 20_000)), (
        id_col(),
        fk("hub_id", "hub", a=round(float(rng.uniform(1.0, 1.4)), 2)),
        cat("reputation", 0, int(rng.integers(50, 200))))))
    tables.append(TableSpec("item", int(rng.integers(15_000, 60_000)), (
        id_col(),
        fk("hub_id", "hub", a=round(float(rng.uniform(1.0, 1.4)), 2)),
        fk("owner_id", "person", a=_zipf_a(rng)),
        _wide(rng, "score"))))
    n_sat = int(rng.integers(2, 5))
    for i in range(n_sat):
        cols = [fk("item_id", "item", a=_zipf_a(rng))]
        if rng.random() < 0.8:
            # the STACK-style hub gather: this satellite's hub_id is the
            # parent item's hub_id looked up through a fresh fk draw
            cols.append(fk("hub_id", "item", a=_zipf_a(rng), via="hub_id"))
        if rng.random() < 0.5:
            cols.append(fk("owner_id", "person", a=_zipf_a(rng)))
        cols.append(_narrow(rng, "k0"))
        _maybe_cat2(rng, cols)
        tables.append(TableSpec(f"act{i}", int(rng.integers(30_000, 120_000)),
                                tuple(cols)))
    if rng.random() < 0.6:        # tag-like dim + bridge
        tables.append(TableSpec("label", int(rng.integers(300, 2000)), (
            id_col(),
            fk("hub_id", "hub", a=round(float(rng.uniform(1.0, 1.4)), 2)))))
        tables.append(TableSpec("item_label",
                                int(rng.integers(40_000, 150_000)), (
                                    fk("item_id", "item", a=_zipf_a(rng)),
                                    fk("label_id", "label",
                                       a=_zipf_a(rng)))))
    return tables


_BUILDERS = {"star": _star, "snowflake": _snowflake, "person": _person}


def sample_schema(seed: int, family: Optional[str] = None) -> SchemaSpec:
    """Draw one random schema. `family=None` picks uniformly (the draw is
    consumed either way, so fixing the family never shifts the rest of
    the stream)."""
    rng = np.random.default_rng(seed)
    pick = FAMILIES[int(rng.integers(len(FAMILIES)))]
    fam = family if family is not None else pick
    assert fam in _BUILDERS, f"unknown schema family {fam!r}"
    spec = SchemaSpec(f"{fam}{seed}", tuple(_BUILDERS[fam](rng)), family=fam)
    assert_valid(spec)
    _assert_connected(spec)
    return spec


def _assert_connected(spec: SchemaSpec) -> None:
    """All joinable tables must sit in ONE fk component — otherwise the
    query sampler stalls below its requested join arity. Families
    guarantee this via the shared hub fk; this catches regressions."""
    edges = join_edges(spec)
    adj: dict = {}
    for c, _, p, _ in edges:
        adj.setdefault(c, set()).add(p)
        adj.setdefault(p, set()).add(c)
    if not adj:
        raise AssertionError(f"{spec.name}: no joinable fk edges")
    seen, todo = set(), [next(iter(adj))]
    while todo:
        t = todo.pop()
        if t in seen:
            continue
        seen.add(t)
        todo.extend(adj[t])
    assert seen == set(adj), \
        f"{spec.name}: disconnected fk graph {sorted(set(adj) - seen)}"
