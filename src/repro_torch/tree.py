"""Nested-dict pytrees: the port's stand-in for `jax.tree_util`.

A tree is a dict whose values are trees or leaves (tensors, arrays).
Leaves come out in the order `jax.tree_util` gives a dict: keys sorted
at every level. A leaf's path joins its keys with "/", which is the leaf
name the reference's checkpoints use ("aopt/m/enc/conv1/wr").

A list node (the reference's QueryFormer keeps its layers in one) is read
as a dict keyed "0", "1", ...: the names `nn.ModuleList` gives its
children and the path the reference's checkpoints write
("actor/enc/layers/0/wq"). `tree_map` and `unflatten` return such a node
as that dict, so a reference tree carried across takes the port's shape.
Keys sort as strings, which is the list's order for fewer than ten
entries.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def is_node(x) -> bool:
    return isinstance(x, (dict, list))


def children(node) -> Dict:
    """A node's children by key: a dict itself, a list keyed "0", "1", ..."""
    if isinstance(node, list):
        return {str(i): v for i, v in enumerate(node)}
    return node


def flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs, keys sorted at every level."""
    if not is_node(tree):
        return [(prefix, tree)]
    out = []
    kids = children(tree)
    for k in sorted(kids):
        out += flatten(kids[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if not is_node(tree):
        return fn(tree, *rest)
    rest = [children(r) for r in rest]
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in children(tree).items()}


def unflatten(tree_like, named: Dict[str, object]):
    """`tree_like`'s structure with each leaf replaced by `named[path]`."""
    def build(node, prefix):
        if not is_node(node):
            return named[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in children(node).items()}
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
