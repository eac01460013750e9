"""Pytrees of tensors in JAX's order (the port's counterpart of the parts of
``jax.tree_util`` that the trainer uses).

A node is a dict (children in sorted key order, as JAX flattens dicts), a
list or tuple (in order) or a dataclass instance (its fields in declaration
order, as ``jax.tree_util.register_dataclass`` flattens them); ``None`` is a
node with no children; anything else is a leaf.  Names are
``jax.tree_util.keystr``'s: ``.params['layers']['wq']``, ``[0]``,
``.opt.step``.  The order decides how a global norm sums its leaves and how
a checkpoint names its arrays, so both packages agree on both.
"""

from __future__ import annotations

import dataclasses


def _is_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _children(tree):
    """``(name suffix, child)`` pairs of a node in JAX's order, or None for
    a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if _is_dataclass(tree):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if tree is None:
        return []
    return None


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(keystr name, leaf)`` pairs in JAX's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += flatten_with_names(child, prefix + name)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), in a tree of ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if _is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """``leaves`` (in JAX's order) put back into the structure of ``like``."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        if _is_dataclass(tree):
            return type(tree)(**{f.name: build(getattr(tree, f.name))
                                 for f in dataclasses.fields(tree)})
        if tree is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
