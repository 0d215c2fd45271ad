"""Nested-dict trees of tensors: the param trees of the port, walked in
sorted key order as JAX flattens a dict, so a sum over the leaves adds
them in the reference's order."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys); dicts are rebuilt in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: list) -> Any:
    """A tree shaped as ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
