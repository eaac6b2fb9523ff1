"""Nested dict / list trees of tensors: the leaves, a map over them and
the way back, in the order jax.tree gives (dict keys sorted)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict / list tree, dict keys in sorted order (the
    order jax.tree.leaves gives)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of trees of one structure, in tree_leaves order;
    the result's dicts and lists are of ``tree``'s types (a dict subclass
    such as models/nn.py ShardedMLP is kept)."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return out if type(tree) is dict else type(tree)(out)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` (tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
