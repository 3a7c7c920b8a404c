"""The world generator's schema grammar: declarative table/column specs.

A `SchemaSpec` is pure data — an ordered tuple of `TableSpec`s, each an
ordered tuple of `ColumnSpec`s — expressive enough that the hand-built
JOB-like and STACK-like schemas in `sql.datagen` are thin instances of
it, and constrained enough that every sampled instance is valid by
construction (acyclic FK DAG, dense join keys, joinable templates).

Column kinds (each maps onto exactly one numpy draw sequence, so a spec
plus a seed determines the database bit-for-bit — see
`sql.datagen.make_db_from_spec`):

  id    dense primary key 0..n-1 (no RNG draw). Any table that is the
        parent of an `fk` column must have one.
  cat   categorical/ordinal: uniform integers in [lo, hi). Wide ranges
        (e.g. production_year-like timestamps) support range filters;
        narrow ones support IN filters.
  cat2  two-regime categorical correlated with an earlier column of the
        same table: rows where `src` > `threshold` draw from [0, hi_k),
        the rest from [0, lo_k) — the title.kind_id-style correlation
        that breaks the CBO's independence assumption.
  fk    foreign key into `parent`'s dense id: Zipf-skewed with exponent
        `a` (hub identity SHARED across every fk into the same parent —
        the cross-table correlation) or uniform when `skew=False`. With
        `via=<col>` the drawn key is not stored; the parent's `via`
        column is gathered through it instead (the STACK
        answer.site_id = question.site_id[fk] hub correlation), which
        makes the column joinable against whatever `via` itself
        references.

`order` hoists a column's RNG draw ahead of the natural
table-major/column-minor sequence (the STACK schema draws
question.site_id before any other column); hoisting changes only WHEN
the draw happens, never where the column lands.

This module is dependency-free (numpy only): `sql.datagen` imports it to
materialize specs, and the samplers in `repro_torch.gen` build on top.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["ColumnSpec", "TableSpec", "SchemaSpec", "id_col", "cat", "cat2",
           "fk", "spec_rows", "join_edges", "fk_parents", "assert_valid",
           "delete_safe_tables"]


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str                      # "id" | "cat" | "cat2" | "fk"
    # cat: uniform integers in [lo, hi)
    lo: int = 0
    hi: int = 2
    # cat2: two-regime categorical correlated with `src` of the same table
    src: str = ""
    threshold: int = 0
    hi_k: int = 2                  # domain where src > threshold
    lo_k: int = 2                  # domain elsewhere
    # fk: keys into parent's dense id
    parent: str = ""
    a: float = 0.8                 # Zipf exponent (skew=True)
    skew: bool = True
    via: str = ""                  # gather parent's `via` column instead
    # global draw-order hoist (None = natural sequence)
    order: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """`n_rows` is the row count at scale=1.0; scaled tables follow
    `max(16, int(n_rows * scale))` while `fixed=True` tables (tiny
    enumeration dims like info_type) keep `n_rows` literally.
    `size_with` scales the realized count by the named table's
    realized/spec ratio — the cascade that shrinks fact tables when a
    root snapshot filter (e.g. IMDb-1980) drops rows."""
    name: str
    n_rows: int
    columns: Tuple[ColumnSpec, ...]
    fixed: bool = False
    size_with: str = ""


@dataclasses.dataclass(frozen=True)
class SchemaSpec:
    name: str
    tables: Tuple[TableSpec, ...]
    family: str = ""               # sampler family ("" = hand-built)

    def table(self, name: str) -> TableSpec:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)


# ------------------------------------------------------- column factories
def id_col() -> ColumnSpec:
    return ColumnSpec("id", "id")


def cat(name: str, lo: int, hi: int) -> ColumnSpec:
    return ColumnSpec(name, "cat", lo=lo, hi=hi)


def cat2(name: str, src: str, threshold: int, hi_k: int,
         lo_k: int) -> ColumnSpec:
    return ColumnSpec(name, "cat2", src=src, threshold=threshold,
                      hi_k=hi_k, lo_k=lo_k)


def fk(name: str, parent: str, a: float = 0.8, skew: bool = True,
       via: str = "", order: Optional[int] = None) -> ColumnSpec:
    return ColumnSpec(name, "fk", parent=parent, a=a, skew=skew, via=via,
                      order=order)


# ------------------------------------------------------------- derived
def spec_rows(t: TableSpec, scale: float) -> int:
    """Row count of `t` at `scale` before size_with cascades."""
    return t.n_rows if t.fixed else max(16, int(t.n_rows * scale))


def _resolve_join_target(spec: SchemaSpec, col: ColumnSpec,
                         depth: int = 0) -> Tuple[str, str]:
    """The (table, column) a fk column's VALUES join against: the
    parent's id for plain fks; for `via` gathers, whatever the parent's
    via column itself joins against (chased transitively)."""
    if not col.via:
        return col.parent, "id"
    assert depth < 8, "via chain too deep (cycle?)"
    pcol = next(c for c in spec.table(col.parent).columns
                if c.name == col.via)
    if pcol.kind == "fk":
        return _resolve_join_target(spec, pcol, depth + 1)
    return col.parent, col.via     # gathered attribute, not a key


def join_edges(spec: SchemaSpec) -> List[Tuple[str, str, str, str]]:
    """Equi-joinable edges (child_table, child_col, parent_table,
    parent_col): every fk column against the dense id (or gathered key)
    its values actually come from — the walkable graph the query sampler
    draws acyclic join trees over."""
    edges = []
    for t in spec.tables:
        for c in t.columns:
            if c.kind == "fk":
                pt, pc = _resolve_join_target(spec, c)
                if pc == "id":     # only key-valued columns are join edges
                    edges.append((t.name, c.name, pt, pc))
    return edges


def fk_parents(spec: SchemaSpec) -> Dict[str, List[str]]:
    """child table -> parent tables over RAW fk references (the FK DAG:
    `via` gathers still reference their immediate parent)."""
    out: Dict[str, List[str]] = {t.name: [] for t in spec.tables}
    for t in spec.tables:
        for c in t.columns:
            if c.kind == "fk":
                out[t.name].append(c.parent)
    return out


def delete_safe_tables(spec: SchemaSpec) -> Tuple[str, ...]:
    """Tables where row deletion cannot dangle a foreign key: no other
    table's fk targets them, and they carry no dense id (so no external
    contract on key density). These are the stream sampler's legal
    delete/update targets."""
    referenced = {c.parent for t in spec.tables for c in t.columns
                  if c.kind == "fk"}
    return tuple(t.name for t in spec.tables
                 if t.name not in referenced
                 and not any(c.kind == "id" for c in t.columns))


def assert_valid(spec: SchemaSpec) -> None:
    """Structural validity: unique names, every fk parent exists and has
    a dense id, `via`/`src` references resolve to earlier-materialized
    columns, and the FK reference graph is acyclic (so the join graph is
    walkable and materialization order is well-defined)."""
    names = [t.name for t in spec.tables]
    assert len(names) == len(set(names)), f"duplicate tables in {spec.name}"
    by_name = {t.name: t for t in spec.tables}
    pos = {t.name: i for i, t in enumerate(spec.tables)}
    for t in spec.tables:
        cnames = [c.name for c in t.columns]
        assert len(cnames) == len(set(cnames)), \
            f"duplicate columns in {spec.name}.{t.name}"
        seen = set()
        for c in t.columns:
            if c.kind == "fk":
                assert c.parent in by_name, \
                    f"{t.name}.{c.name}: unknown parent {c.parent}"
                parent = by_name[c.parent]
                assert any(pc.kind == "id" for pc in parent.columns), \
                    f"{t.name}.{c.name}: parent {c.parent} has no dense id"
                if c.via:
                    assert any(pc.name == c.via for pc in parent.columns), \
                        f"{t.name}.{c.name}: via {c.parent}.{c.via} missing"
                    assert pos[c.parent] < pos[t.name], \
                        f"{t.name}.{c.name}: via-parent {c.parent} must " \
                        f"be materialized earlier"
            elif c.kind == "cat2":
                src = next((s for s in t.columns if s.name == c.src), None)
                assert src is not None, \
                    f"{t.name}.{c.name}: cat2 src {c.src} missing"
                # the src must be DRAWN first: earlier in column order, or
                # hoisted ahead of this column's own draw slot
                drawn_first = c.src in seen or (
                    src.order is not None and
                    (c.order is None or src.order < c.order))
                assert drawn_first, \
                    f"{t.name}.{c.name}: cat2 src {c.src} drawn later"
            seen.add(c.name)
        if t.size_with:
            assert t.size_with in by_name and pos[t.size_with] < pos[t.name]
    # FK reference graph (child -> parent) must be acyclic
    parents = fk_parents(spec)
    state: Dict[str, int] = {}     # 0 visiting, 1 done

    def visit(n: str, trail: Tuple[str, ...]) -> None:
        if state.get(n) == 1:
            return
        assert state.get(n) != 0, \
            f"FK cycle in {spec.name}: {' -> '.join(trail + (n,))}"
        state[n] = 0
        for p in parents[n]:
            visit(p, trail + (n,))
        state[n] = 1

    for t in spec.tables:
        visit(t.name, ())
