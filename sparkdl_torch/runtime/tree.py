"""Nested containers of arrays ("trees") as the runtime moves them: a
batch dict, a tuple of outputs, or a single array. The port's stand-in for
``jax.tree.map``/``jax.tree.leaves`` over the shapes the feed uses: dicts,
lists and tuples; anything else is a leaf."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> "list[Any]":
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
