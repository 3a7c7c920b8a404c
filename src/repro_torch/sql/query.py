"""Query model: join graphs with per-relation filters.

A Query is a connected equi-join graph over table *aliases* (self-joins get
distinct aliases, as in JOB) plus conjunctive filters. The syntactic order
of `relations` is what Spark executes when the CBO is off ("directly
executes the join order specified in the input SQL text", §VII-B2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Filter:
    column: str
    op: str              # "<=", ">=", "==", "in"
    value: Tuple         # scalar or tuple of values

    def apply(self, arr: np.ndarray) -> np.ndarray:
        if self.op == "<=":
            return arr <= self.value[0]
        if self.op == ">=":
            return arr >= self.value[0]
        if self.op == "==":
            return arr == self.value[0]
        if self.op == "in":
            return np.isin(arr, np.asarray(self.value))
        raise ValueError(self.op)

    def selectivity_est(self, cstats) -> float:
        """CBO selectivity estimate (uniformity assumption)."""
        lo, hi, nd = cstats.min_val, cstats.max_val, cstats.n_distinct
        width = max(hi - lo, 1.0)
        if self.op == "<=":
            return float(np.clip((self.value[0] - lo + 1) / width, 0.0, 1.0))
        if self.op == ">=":
            return float(np.clip((hi - self.value[0] + 1) / width, 0.0, 1.0))
        if self.op == "==":
            return 1.0 / nd
        if self.op == "in":
            return min(1.0, len(self.value) / nd)
        raise ValueError(self.op)


@dataclasses.dataclass(frozen=True)
class Relation:
    alias: str
    table: str
    filters: Tuple[Filter, ...] = ()


@dataclasses.dataclass(frozen=True)
class JoinCond:
    """Equi-join: left_alias.left_col == right_alias.right_col."""
    left: str
    lcol: str
    right: str
    rcol: str

    def touches(self, alias: str) -> bool:
        return self.left == alias or self.right == alias

    def other(self, alias: str) -> str:
        return self.right if self.left == alias else self.left


@dataclasses.dataclass(frozen=True)
class Query:
    name: str
    relations: Tuple[Relation, ...]          # syntactic order
    conds: Tuple[JoinCond, ...]

    @property
    def n_relations(self) -> int:
        return len(self.relations)

    def relation(self, alias: str) -> Relation:
        for r in self.relations:
            if r.alias == alias:
                return r
        raise KeyError(alias)

    def adjacency(self) -> Dict[str, List[str]]:
        adj: Dict[str, List[str]] = {r.alias: [] for r in self.relations}
        for c in self.conds:
            adj[c.left].append(c.right)
            adj[c.right].append(c.left)
        return adj

    def conds_between(self, covered: frozenset, alias_set: frozenset):
        """Join conditions linking two disjoint alias sets."""
        out = []
        for c in self.conds:
            if ((c.left in covered and c.right in alias_set) or
                    (c.right in covered and c.left in alias_set)):
                out.append(c)
        return out

    def is_connected(self) -> bool:
        if not self.relations:
            return False
        adj = self.adjacency()
        seen = {self.relations[0].alias}
        stack = [self.relations[0].alias]
        while stack:
            for nxt in adj[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return len(seen) == len(self.relations)
