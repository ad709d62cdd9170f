"""Nested dicts, tuples and lists of tensors: the port's pytrees.

The training state (parameters, optimizer state, gradients) is a tree of
dicts, tuples and lists with tensors at the leaves. Leaves are visited in
JAX's order: dict keys sorted, tuples and lists by index, so a leaf's
name and position here equal the reference's (`jax.tree_util`), which is
what lets the two packages read each other's checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable


def _items(tree) -> list | None:
    """(key, subtree) pairs in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def named_leaves(tree, path: tuple = ()) -> list[tuple[str, Any]]:
    """(name, leaf) in JAX's order; a name joins the path's keys and
    indices with "__" ("0__blocks__wq"), "leaf" for a bare leaf."""
    items = _items(tree)
    if items is None:
        return [("__".join(map(str, path)) or "leaf", tree)]
    return [pair for k, sub in items
            for pair in named_leaves(sub, path + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree`, each with the subtrees of `rest` at
    the same place (so a leaf of `tree` may meet a whole subtree of a
    state, as `flatten_up_to` does); keys are visited in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """fn(path, leaf) over the leaves of `tree`; a path is the tuple of
    dict keys and sequence indices from the root (the port's counterpart
    of `jax.tree_util.tree_map_with_path`)."""
    items = _items(tree)
    if items is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, sub, path + (k,))
                for k, sub in items}
    return type(tree)(tree_map_with_path(fn, sub, path + (k,))
                      for k, sub in items)


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves are `new_leaves`, in the
    order `leaves(like)` gives."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out
