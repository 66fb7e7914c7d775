"""Pytree helpers over plain dicts / lists / tuples of tensors.

They reproduce ``jax.tree_util``'s leaf order — dict keys sorted, lists
and tuples in order, ``None`` an empty subtree — so a parameter tree in
the JAX structure flattens to the same leaf sequence here as in the
reference, and the flat store (``core.flat``) lays it out byte-for-byte
the same way.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

# a treedef is a hashable nested tuple: ("leaf",), ("none",),
# ("dict", keys, children), ("list", children), ("tuple", children)
_LEAF = ("leaf",)
_NONE = ("none",)


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return _NONE
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, tuple(walk(c) for c in t))
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (all of
    ``tree``'s structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
