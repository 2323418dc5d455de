"""Trees of tensors: NamedTuples, tuples, lists and dicts (dict keys in
sorted order, as ``jax.tree_util`` orders them); anything else is a leaf."""

from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*children)
    return type(tree)(children)


def tree_leaves(tree) -> list:
    """The leaves in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_leaves(k)]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return _rebuild(tree, [tree_map(fn, k) for k in kids])


def tree_unflatten(example, leaves):
    """``example``'s structure refilled with ``leaves`` in flattening order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), example)
