"""QuerySampler: acyclic join templates over a sampled schema's FK graph.

BRAD-style: a template is a random TREE WALK over `spec.join_edges` —
each step attaches a NEW table through one fk edge, so every template is
connected and acyclic by construction and every join condition is an
equi-join between a real fk column and the dense key its values were
drawn from (no empty-result joins by construction). Filter SLOTS are
chosen per template (which columns, which shape); the CONSTANTS are
drawn per instantiation, always inside the column's declared [lo, hi)
domain, mirroring how the hand-built JOB/STACK templates randomize
predicates while preserving join structure:

  narrow cat (domain < 64)   IN filter, 1-5 values
  wide cat                   production_year-style closed range
  cat2                       IN over the union regime [0, max(hi_k, lo_k))
  id of a FIXED table        IN over [0, n_rows) (site-style; only fixed
                             tables, whose row count is scale-invariant,
                             can safely pin id constants)

`sample_templates(spec, seed, ...)` returns (name, fn(rng)) pairs with
the exact shape `sql.workloads` templates have, and
`make_gen_workload` / `gen_query_stream` mirror
`workloads.make_workload` / `workloads.query_stream` — including the
disjoint train/test seed partition from `repro_torch.gen.seeds`, so generated
workloads plug into `WorkloadMeta.from_workload`, `AqoraAgent` and the
serving driver unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.gen.seeds import split_train_test
from repro_torch.gen.spec import SchemaSpec, join_edges
from repro_torch.sql.query import Filter, JoinCond, Query, Relation
from repro_torch.sql.workloads import Workload, shuffle_relations

__all__ = ["sample_templates", "make_gen_workload", "gen_query_stream"]


# ------------------------------------------------------------ filter slots
def _filter_slots(spec: SchemaSpec, table: str, rng,
                  p_root: float) -> Tuple[Tuple, ...]:
    """Pick the filterable columns of `table` for one template. Each slot
    is (col_name, kind, lo, hi) with constants drawn at instantiation."""
    t = spec.table(table)
    slots = []
    for c in t.columns:
        if c.kind == "cat":
            if rng.random() >= p_root:
                continue
            if c.hi - c.lo < 64:
                slots.append((c.name, "in", c.lo, c.hi))
            else:
                slots.append((c.name, "range", c.lo, c.hi))
        elif c.kind == "cat2" and rng.random() < p_root:
            slots.append((c.name, "in", 0, max(c.hi_k, c.lo_k)))
        elif c.kind == "id" and t.fixed and rng.random() < p_root:
            slots.append((c.name, "in", 0, t.n_rows))
    return tuple(slots)


def _draw_filters(slots: Sequence[Tuple], rng) -> Tuple[Filter, ...]:
    out: List[Filter] = []
    for name, kind, lo, hi in slots:
        if kind == "in":
            k = int(rng.integers(1, min(6, hi - lo) + 1))
            vals = tuple(int(v) for v in
                         lo + rng.choice(hi - lo, size=k, replace=False))
            out.append(Filter(name, "in", vals))
        else:
            a = int(rng.integers(lo + 1, hi))
            w = int(rng.integers(max(1, (hi - lo) // 50),
                                 max(2, (hi - lo) // 3)))
            out.append(Filter(name, ">=", (max(lo, a - w),)))
            out.append(Filter(name, "<=", (a,)))
    return tuple(out)


# --------------------------------------------------------------- templates
def _sample_structure(spec: SchemaSpec, rng, n_tables: int):
    """One random join tree: (ordered tables, alias map, alias-level join
    conds). Walks fk edges outward from a random fact-ish root, adding
    only unvisited tables (acyclic + connected by construction). At most
    TWO fk children may share one parent key per template: a k-spoke star
    through a tiny Zipf hub multiplies the spokes' row counts and blows
    the executor's materialize cap under EVERY join order — the
    generator's job is controlled selectivity, so unfixable-by-planning
    queries are excluded by construction (deliberate stragglers live in
    tests/scenarios.py, not here)."""
    edges = join_edges(spec)
    assert edges, f"{spec.name}: no joinable fk edges"
    # roots that actually have edges; prefer fk-rich children (facts)
    fanout: Dict[str, int] = {}
    for c, _, p, _ in edges:
        fanout[c] = fanout.get(c, 0) + 1
        fanout.setdefault(p, 0)
    roots = sorted(fanout, key=lambda t: (-fanout[t], t))
    root = roots[int(rng.integers(max(1, min(3, len(roots)))))]
    chosen = [root]
    alias = {root: "r0"}
    kids: Dict[str, int] = {}        # parent table -> fk children in tree
    conds: List[Tuple[str, str, str, str]] = []   # (table, col, ptable, pcol)
    while len(chosen) < n_tables:
        grow = [(c, cc, p, pc) for c, cc, p, pc in edges
                if (c in alias) != (p in alias) and kids.get(p, 0) < 2]
        if not grow:
            break
        c, cc, p, pc = grow[int(rng.integers(len(grow)))]
        new = p if c in alias else c
        alias[new] = f"r{len(chosen)}"
        chosen.append(new)
        kids[p] = kids.get(p, 0) + 1
        conds.append((c, cc, p, pc))
    return chosen, alias, conds


def sample_templates(spec: SchemaSpec, seed: int, *, n_templates: int = 10,
                     t_min: int = 3, t_max: int = 8,
                     p_filter: float = 0.55
                     ) -> List[Tuple[str, Callable]]:
    """Template family for one schema: join structure + filter slots are
    fixed per template here; each call of a template's fn(rng) draws
    fresh predicate constants (exactly the `sql.workloads` contract)."""
    rng = np.random.default_rng(seed)
    n_avail = len({t for e in join_edges(spec) for t in (e[0], e[2])})
    templates: List[Tuple[str, Callable]] = []
    for i in range(n_templates):
        want = int(rng.integers(t_min, min(t_max, n_avail) + 1))
        tables, alias, conds = _sample_structure(spec, rng, want)
        slots = {t: _filter_slots(spec, t, rng,
                                  p_filter if t == tables[0] else
                                  p_filter * 0.6)
                 for t in tables}
        if not any(slots.values()):   # every template filters SOMETHING
            t0 = spec.table(tables[0])
            cands = [c for c in t0.columns if c.kind == "cat"]
            if cands:
                c = cands[0]
                kind = "in" if c.hi - c.lo < 64 else "range"
                slots[tables[0]] = ((c.name, kind, c.lo, c.hi),)

        def fn(rng, tables=tables, alias=alias, conds=conds, slots=slots):
            rels = tuple(Relation(alias[t], t, _draw_filters(slots[t], rng))
                         for t in tables)
            jc = tuple(JoinCond(alias[c], cc, alias[p], pc)
                       for c, cc, p, pc in conds)
            return rels, jc

        templates.append((f"g{i + 1}", fn))
    return templates


# ------------------------------------------------- workload / stream build
def make_gen_workload(spec: SchemaSpec, base_seed: int, *,
                      n_templates: int = 10, n_train: int = 40,
                      n_test_per_template: int = 2,
                      t_min: int = 3, t_max: int = 8) -> Workload:
    """`workloads.make_workload` over a sampled schema: train constants
    from the train seed stream, test from the disjoint test stream
    (`gen.seeds.split_train_test` — same partition the hand-built
    benchmarks use)."""
    templates = sample_templates(spec, base_seed, n_templates=n_templates,
                                 t_min=t_min, t_max=t_max)
    tr_seed, te_seed = split_train_test(base_seed)
    train: List[Query] = []
    rng = np.random.default_rng(tr_seed)
    i = 0
    while len(train) < n_train:
        tname, fn = templates[i % len(templates)]
        rels, conds = shuffle_relations(*fn(rng), rng)
        train.append(Query(f"{spec.name}/{tname}#tr{len(train)}", rels,
                           conds))
        i += 1
    test: List[Query] = []
    rng_t = np.random.default_rng(te_seed)
    for tname, fn in templates:
        for j in range(n_test_per_template):
            rels, conds = shuffle_relations(*fn(rng_t), rng_t)
            test.append(Query(f"{spec.name}/{tname}#{j}", rels, conds))
    mt = max(q.n_relations for q in train + test)
    return Workload(spec.name, mt, train, test)


def gen_query_stream(spec: SchemaSpec, base_seed: int, *,
                     n_templates: int = 10, t_min: int = 3, t_max: int = 8):
    """Endless generator of fresh instantiations (round-robin over the
    schema's templates) — the generated-world analogue of
    `workloads.query_stream`, for the open-loop serving driver."""
    templates = sample_templates(spec, base_seed, n_templates=n_templates,
                                 t_min=t_min, t_max=t_max)
    tr_seed, _ = split_train_test(base_seed)
    rng = np.random.default_rng(tr_seed)
    i = 0
    while True:
        tname, fn = templates[i % len(templates)]
        rels, conds = shuffle_relations(*fn(rng), rng)
        yield Query(f"{spec.name}/{tname}#st{i}", rels, conds)
        i += 1
