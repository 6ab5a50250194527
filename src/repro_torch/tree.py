"""Nested containers of tensors ("trees"): the few ``jax.tree`` functions
the port's training code needs.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (anything
else). Dicts are visited in sorted key order, as ``jax.tree`` visits them,
so leaves come out in the reference's order and a path names a leaf as the
reference's checkpoint keys do: a dict key, ``#i`` for a list or tuple
position, the field name of a NamedTuple.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths", "tree_unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which have the same structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in order; ``path`` joins the keys
    with ``/`` (``layers/#0/mlp/#1/w``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", x) for i, x in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(tree_paths(sub, prefix + (key,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out
