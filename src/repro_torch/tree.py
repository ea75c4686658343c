"""Nested-container trees, flattened the way `jax.tree` flattens them.

The reference walks caches, spec trees and payloads with `jax.tree`:
dicts flatten in **sorted key order**, lists and tuples in order, and
``None`` is an empty subtree with no leaves. The port flattens the same
way, so a leaf list taken from a port tree and one taken from the
reference's tree compare 1:1 (an insertion-order walk would agree on
``{"k", "v"}`` by luck and disagree elsewhere).
"""
from __future__ import annotations

from typing import Any, Callable


def _children(x):
    """(kind, keys, children) of a container node, or None for a leaf."""
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict", keys, [x[k] for k in keys]
    if isinstance(x, (list, tuple)):
        return type(x), None, list(x)
    return None


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The leaves of `tree` in `jax.tree.leaves` order."""
    out: list = []

    def walk(x):
        if x is None:
            return
        if is_leaf is not None and is_leaf(x):
            out.append(x)
            return
        node = _children(x)
        if node is None:
            out.append(x)
            return
        for c in node[2]:
            walk(c)
    walk(tree)
    return out


def map(fn: Callable, tree, *rest,
        is_leaf: Callable[[Any], bool] | None = None):
    """`fn` applied leaf-wise over `tree` (and the same-shaped trees in
    `rest`), keeping `tree`'s containers — `jax.tree.map`'s contract."""
    def walk(x, *ys):
        if x is None:
            return None
        if is_leaf is not None and is_leaf(x):
            return fn(x, *ys)
        node = _children(x)
        if node is None:
            return fn(x, *ys)
        kind, keys, kids = node
        if kind == "dict":
            for y in ys:
                if not isinstance(y, dict) or sorted(y) != keys:
                    raise ValueError("tree structures differ")
            return {k: walk(x[k], *(y[k] for y in ys)) for k in keys}
        for y in ys:
            if not isinstance(y, (list, tuple)) or len(y) != len(kids):
                raise ValueError("tree structures differ")
        out = [walk(c, *(y[i] for y in ys)) for i, c in enumerate(kids)]
        return out if kind is list else kind(out)
    return walk(tree, *rest)


def unflatten(template, leaves: list):
    """`template`'s containers holding `leaves` in `leaves` order (the
    inverse of `leaves(template)`)."""
    it = iter(leaves)
    out = map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def flatten_with_keys(tree) -> list[tuple[str, Any]]:
    """(keypath, leaf) pairs in `jax.tree.leaves` order, the keypath a
    dict key or sequence index per level joined with ``/``: the key
    strings of the reference's checkpoints (`repro.train.checkpoint`
    `_keystr`), so a checkpoint crosses between the packages."""
    out: list = []

    def walk(x, path):
        if x is None:
            return
        node = _children(x)
        if node is None:
            out.append(("/".join(path), x))
            return
        kind, keys, kids = node
        names = keys if kind == "dict" else range(len(kids))
        for name, c in zip(names, kids):
            walk(c, path + [str(name)])
    walk(tree, [])
    return out
