"""Nested-dict pytrees: the port's stand-in for `jax.tree_util`.

A tree is a dict whose values are trees or leaves (tensors, arrays).
Leaves come out in the order `jax.tree_util` gives a dict: keys sorted
at every level. A leaf's path joins its keys with "/", which is the leaf
name the reference's checkpoints use ("aopt/m/enc/conv1/wr").
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs, keys sorted at every level."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def unflatten(tree_like, named: Dict[str, object]):
    """`tree_like`'s structure with each leaf replaced by `named[path]`."""
    def build(node, prefix):
        if not isinstance(node, dict):
            return named[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in node.items()}
    return build(tree_like, "")


def nest(named: Dict[str, object], sep: str = ".") -> Dict:
    """{"enc.conv1.wr": x} -> {"enc": {"conv1": {"wr": x}}}."""
    out: Dict = {}
    for name, leaf in named.items():
        node = out
        *parents, last = name.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
