"""Nested-dict parameter trees: the stand-in for ``jax.tree_util``.

Leaves come in ``jax.tree_util.tree_flatten`` order for dicts (keys sorted),
so a leaf's index and its ``"/"``-joined path name are the same in both
packages.  Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_path(tree[k], prefix + (str(k),)))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (and matching leaves of
    ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def unflatten_like(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    paths = [p for p, _ in leaves_with_path(tree)]
    out: dict = {}
    for path in paths:
        if not path:
            return next(it)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = next(it)
    return out
