"""Physical plan trees + the paper's Alg. 2 swap/lead transformation.

A plan is a binary tree of Join nodes over Leaf nodes. A Leaf is either a
base-table scan or a *stage result* (a materialized intermediate covering
several aliases) — during adaptive execution the remaining plan's leaves
are exactly these two kinds, matching the paper's observation that "during
AQE, even leaf nodes may touch multiple tables" (§V-B2).

Join methods: SMJ (shuffle sort-merge: both inputs hash-repartitioned on the
join key unless already partitioned on it) and BHJ (broadcast hash join:
build side replicated to every executor, probe side pipelined, no shuffle).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.sql.query import JoinCond, Query

SMJ = "SMJ"
BHJ = "BHJ"


@dataclasses.dataclass
class Leaf:
    aliases: frozenset                 # alias set covered
    stage_id: Optional[int] = None     # None -> base scan, else intermediate
    broadcast_hint: bool = False

    @property
    def alias(self) -> str:
        assert len(self.aliases) == 1
        return next(iter(self.aliases))

    def covered(self) -> frozenset:
        return self.aliases


@dataclasses.dataclass
class Join:
    left: "Node"
    right: "Node"
    conds: Tuple[JoinCond, ...]
    method: str = SMJ                  # planner's choice; AQE may switch

    def covered(self) -> frozenset:
        return self.left.covered() | self.right.covered()


Node = object  # Leaf | Join


# ------------------------------------------------------------------ helpers
def leaves(plan: Node) -> List[Leaf]:
    """Left-to-right leaf order (the paper's 1-indexed leaf positions)."""
    if isinstance(plan, Leaf):
        return [plan]
    return leaves(plan.left) + leaves(plan.right)


def joins(plan: Node) -> List[Join]:
    if isinstance(plan, Leaf):
        return []
    return joins(plan.left) + joins(plan.right) + [plan]


def count_nodes(plan: Node) -> int:
    if isinstance(plan, Leaf):
        return 1
    return 1 + count_nodes(plan.left) + count_nodes(plan.right)


def is_bushy(plan: Node) -> bool:
    """True if some join's right child is itself a join."""
    if isinstance(plan, Leaf):
        return False
    return isinstance(plan.right, Join) or is_bushy(plan.left) or is_bushy(plan.right)


def copy_plan(plan: Node) -> Node:
    if isinstance(plan, Leaf):
        return Leaf(plan.aliases, plan.stage_id, plan.broadcast_hint)
    return Join(copy_plan(plan.left), copy_plan(plan.right), plan.conds,
                plan.method)


# ------------------------------------------------------------------ builders
def build_left_deep(query: Query, leaf_order: List[Leaf]) -> Optional[Node]:
    """Alg. 2 core loop: fold leaves left-deep, requiring a join condition
    connecting each new leaf to the prefix (no Cartesian products).
    Returns None if the order is infeasible."""
    plan: Node = leaf_order[0]
    for lf in leaf_order[1:]:
        cs = query.conds_between(frozenset(plan.covered()), frozenset(lf.covered()))
        if not cs:
            return None
        plan = Join(plan, lf, tuple(cs), SMJ)
    return plan


def syntactic_plan(query: Query) -> Node:
    """Spark's no-CBO behaviour: the join order as written in the SQL text."""
    order = [Leaf(frozenset([r.alias])) for r in query.relations]
    plan = build_left_deep(query, order)
    if plan is None:                    # re-greedy from the first relation
        plan = greedy_connected(query, order)
    return plan


def greedy_connected(query: Query, order: List[Leaf]) -> Node:
    """Fallback: keep syntactic order but defer leaves until connected."""
    remaining = list(order)
    plan: Node = remaining.pop(0)
    while remaining:
        for i, lf in enumerate(remaining):
            cs = query.conds_between(frozenset(plan.covered()),
                                     frozenset(lf.covered()))
            if cs:
                plan = Join(plan, remaining.pop(i), tuple(cs), SMJ)
                break
        else:
            raise ValueError(f"{query.name}: join graph disconnected")
    return plan


# ------------------------------------------------------------------ Alg. 2
def apply_swap(query: Query, plan: Node, i: int, j: int) -> Optional[Node]:
    """swap(i, j): exchange the i-th and j-th leaves (1-indexed), rebuild
    left-deep over the new order; None if infeasible (would need a cross
    join) — the runtime then keeps the original plan (Alg. 2 line 9)."""
    lvs = [copy_leaf(l) for l in leaves(plan)]
    n = len(lvs)
    if not (1 <= i < j <= n):
        return None
    lvs[i - 1], lvs[j - 1] = lvs[j - 1], lvs[i - 1]
    return build_left_deep(query, lvs)


def apply_lead(query: Query, plan: Node, i: int) -> Optional[Node]:
    """lead(i): move the i-th leaf to the front (join it first)."""
    lvs = [copy_leaf(l) for l in leaves(plan)]
    n = len(lvs)
    if not (1 <= i <= n) or i == 1:
        return None
    lvs = [lvs[i - 1]] + lvs[:i - 1] + lvs[i:]
    return build_left_deep(query, lvs)


def apply_broadcast(plan: Node, i: int) -> Optional[Node]:
    """broadcast(i): annotate the i-th leaf with a BROADCAST hint; the
    planner then forces BHJ for the join touching it (bottom-up search,
    §VI-B2)."""
    new = copy_plan(plan)
    lvs = leaves(new)
    if not (1 <= i <= len(lvs)) or lvs[i - 1].broadcast_hint:
        return None
    lvs[i - 1].broadcast_hint = True
    return new


def copy_leaf(l: Leaf) -> Leaf:
    return Leaf(l.aliases, l.stage_id, l.broadcast_hint)
