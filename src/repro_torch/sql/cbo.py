"""Cost-based optimizer: estimation + DP join enumeration (System-R style).

Reproduces Spark CBO's behaviour AND its failure mode (paper Fig. 3): the
DP over connected subgraphs is exponential, so planning time blows up with
join count — measured wall time is charged to C_plan. Cardinality
estimates use sampled statistics + independence assumptions, which the
Zipf-skewed data deliberately violates.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.sql.catalog import Database, Stats
from repro_torch.sql.plans import BHJ, Join, Leaf, Node, SMJ, build_left_deep
from repro_torch.sql.query import Query

DP_MAX_RELATIONS = 12          # beyond this, fall back to greedy (and pay
                               # the measured DP time up to the cutoff)


@dataclasses.dataclass
class Estimator:
    """CBO's belief about cardinalities (pre-execution only)."""
    db: Database
    stats: Stats

    def base_rows(self, query: Query, alias: str) -> float:
        rel = query.relation(alias)
        ts = self.stats.tables[rel.table]
        rows = ts.nrows
        for f in rel.filters:
            rows *= f.selectivity_est(ts.columns[f.column])
        return max(rows, 1.0)

    def base_bytes(self, query: Query, alias: str) -> float:
        rel = query.relation(alias)
        width = 8 * max(1, len(self.db.tables[rel.table].columns))
        return self.base_rows(query, alias) * width

    def ndv(self, query: Query, alias: str, col: str) -> float:
        rel = query.relation(alias)
        return max(self.stats.tables[rel.table].columns[col].n_distinct, 1.0)

    def join_rows(self, query: Query, l_set: FrozenSet[str], l_rows: float,
                  r_set: FrozenSet[str], r_rows: float) -> float:
        """|L x R| * prod_conds 1/max(ndv_l, ndv_r) (independence)."""
        sel = 1.0
        for c in query.conds:
            if c.left in l_set and c.right in r_set:
                sel /= max(self.ndv(query, c.left, c.lcol),
                           self.ndv(query, c.right, c.rcol))
            elif c.right in l_set and c.left in r_set:
                sel /= max(self.ndv(query, c.right, c.rcol),
                           self.ndv(query, c.left, c.lcol))
        if sel == 1.0:
            return l_rows * r_rows          # cross join (never chosen)
        return max(l_rows * r_rows * sel, 1.0)

    def width(self, query: Query, aliases: FrozenSet[str]) -> float:
        return 8 * sum(max(1, len(self.db.tables[query.relation(a).table].columns))
                       for a in aliases)


def _connected(query: Query, s: FrozenSet[str]) -> bool:
    if not s:
        return False
    adj = query.adjacency()
    seen = {next(iter(s))}
    stack = [next(iter(s))]
    while stack:
        for nxt in adj[stack.pop()]:
            if nxt in s and nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return len(seen) == len(s)


def dp_join_order(query: Query, est: Estimator) -> Tuple[Optional[Node], float, int]:
    """DPsize over connected subgraphs, C_out cost metric.
    Returns (plan, measured_seconds, n_subproblems)."""
    t0 = time.perf_counter()
    aliases = [r.alias for r in query.relations]
    n = len(aliases)
    best: Dict[FrozenSet[str], Tuple[float, float, Node]] = {}
    for a in aliases:
        s = frozenset([a])
        rows = est.base_rows(query, a)
        best[s] = (0.0, rows, Leaf(s))
    n_sub = 0
    for size in range(2, n + 1):
        for combo in itertools.combinations(aliases, size):
            s = frozenset(combo)
            if not _connected(query, s):
                continue
            best_cost = None
            # split into (left, right) with left a connected proper subset
            members = sorted(s)
            anchor = members[0]
            for lsize in range(1, size):
                for lcombo in itertools.combinations(members, lsize):
                    lset = frozenset(lcombo)
                    if anchor not in lset:      # canonical split (halves work)
                        continue
                    rset = s - lset
                    if lset not in best or rset not in best:
                        continue
                    if not query.conds_between(lset, rset):
                        continue
                    n_sub += 1
                    lcost, lrows, lplan = best[lset]
                    rcost, rrows, rplan = best[rset]
                    out = est.join_rows(query, lset, lrows, rset, rrows)
                    cost = lcost + rcost + out
                    if best_cost is None or cost < best_cost[0]:
                        conds = tuple(query.conds_between(lset, rset))
                        best_cost = (cost, out,
                                     Join(lplan, rplan, conds, SMJ))
            if best_cost is not None:
                best[s] = best_cost
    full = frozenset(aliases)
    elapsed = time.perf_counter() - t0
    if full not in best:
        return None, elapsed, n_sub
    return best[full][2], elapsed, n_sub


def greedy_join_order(query: Query, est: Estimator) -> Node:
    """Min-output-first greedy (what we fall back to past DP_MAX_RELATIONS)."""
    remaining = {r.alias: (est.base_rows(query, r.alias),
                           Leaf(frozenset([r.alias])))
                 for r in query.relations}
    # start from the smallest estimated relation
    cur_alias = min(remaining, key=lambda a: remaining[a][0])
    cur_rows, plan = remaining.pop(cur_alias)
    cur_set = frozenset([cur_alias])
    while remaining:
        cands = []
        for a, (rows, leaf) in remaining.items():
            if query.conds_between(cur_set, frozenset(leaf.covered())):
                out = est.join_rows(query, cur_set, cur_rows,
                                    frozenset([a]), rows)
                cands.append((out, a))
        if not cands:
            a = next(iter(remaining))   # disconnected: take any (cross)
            out = cur_rows * remaining[a][0]
        else:
            out, a = min(cands)
        rows, leaf = remaining.pop(a)
        conds = tuple(query.conds_between(cur_set, frozenset([a])))
        plan = Join(plan, leaf, conds, SMJ)
        cur_set = cur_set | {a}
        cur_rows = out
    return plan


def cbo_plan(query: Query, est: Estimator) -> Tuple[Node, float]:
    """Full CBO: DP when tractable, greedy beyond. Returns (plan, C_plan)."""
    if query.n_relations <= DP_MAX_RELATIONS:
        plan, t, _ = dp_join_order(query, est)
        if plan is not None:
            return plan, t
        return greedy_join_order(query, est), t
    # emulate Spark: DP attempts the prefix, blows up, greedy finishes.
    sub = Query(query.name, query.relations[:DP_MAX_RELATIONS], query.conds)
    _, t_burn, _ = dp_join_order(_restrict(query, DP_MAX_RELATIONS), est)
    return greedy_join_order(query, est), t_burn


def _restrict(query: Query, k: int) -> Query:
    keep = {r.alias for r in query.relations[:k]}
    conds = tuple(c for c in query.conds
                  if c.left in keep and c.right in keep)
    q = Query(query.name, query.relations[:k], conds)
    if not q.is_connected():            # ensure DP has work but stays sane
        keep_rel = [query.relations[0]]
        seen = {query.relations[0].alias}
        adj = query.adjacency()
        frontier = [query.relations[0].alias]
        while frontier and len(keep_rel) < k:
            nxt_alias = frontier.pop(0)
            for nb in adj[nxt_alias]:
                if nb not in seen and len(keep_rel) < k:
                    seen.add(nb)
                    keep_rel.append(query.relation(nb))
                    frontier.append(nb)
        conds = tuple(c for c in query.conds if c.left in seen and c.right in seen)
        q = Query(query.name, tuple(keep_rel), conds)
    return q
