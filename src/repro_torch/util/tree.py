"""Trees of tensors as JAX's pytrees order them.

The port keeps its parameters, optimizer states and batches as plain
trees: dicts, lists, tuples and NamedTuples of tensors (``None`` is an
empty subtree). Where a result depends on the order of the leaves (the
global gradient norm's sum) or names them (checkpoint files), the order is
``jax.tree_util``'s: a dict's children by **sorted key**, a sequence's and
a NamedTuple's in order. :func:`map` keeps each dict's own key order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """``(key, child)`` pairs in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_paths(tree) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` for every leaf, in ``jax.tree_util.tree_flatten_with_path``'s
    order; a path holds dict keys, sequence indices and NamedTuple field names."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((k,) + path, leaf) for k, child in kids for path, leaf in flatten_with_paths(child)]


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(tree_like, new_leaves) -> Any:
    """``tree_like``'s structure holding ``new_leaves`` (in :func:`leaves`' order)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree))
    return fn(tree, *rest)
