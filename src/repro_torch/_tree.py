"""Nested trees of tensors, the port's stand-in for `jax.tree`: a tree is
a dict, list or tuple whose items are trees or leaves, and its leaves
come in JAX's order (dict keys sorted, sequences in order) with JAX's
"/"-joined key paths, so one state tree has one set of leaf names in both
packages."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _items(tree):
    """(key, child) pairs of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's leaf order."""
    items = _items(tree)
    if items is None:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for k, child in items:
        out += tree_flatten_with_path(child, prefix + (str(k),))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching subtrees of `rest`
    (each with `tree`'s structure, or deeper: a leaf of `tree` hands fn
    whatever `rest` holds at its path, as flatten_up_to does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves) -> Any:
    """`leaves` (in JAX's order) put back into `template`'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out
