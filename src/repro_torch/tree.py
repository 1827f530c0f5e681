"""Nested containers of tensors as ``jax.tree`` walks them, for the port's
state trees (parameters, optimizer moments, gradients).

Containers are dicts (children in sorted key order), NamedTuples (in field
order), lists and tuples (in index order); ``None`` is an empty subtree;
anything else is a leaf.  ``tree_leaves`` and ``tree_map`` visit leaves in
that order, so a sum over ``tree_leaves`` adds in the reference's order and a
checkpoint names its arrays as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of a container in ``jax.tree_util`` order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    kids = children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in tree_leaves(child)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    containers."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
