"""Nested dicts of tensors as the training code's pytrees (where the
reference uses ``jax.tree`` over dicts): a leaf's path is its keys, taken
in sorted order as JAX flattens a dict."""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) of every leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_unflatten(items) -> dict:
    """The nested dict of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves (``rest``: trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
