"""Nests of dicts and lists of tensors (the port's parameter and optimiser
trees), walked in the reference's order: ``jax.tree_util`` flattens a dict
by its sorted keys and a list in order, and writes a leaf's path as
``keystr`` does (``['a']`` for a dict key, ``[0]`` for a list item)."""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

Tree = Any


def leaves_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path`` order, the
    path as ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, Mapping):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in leaves_with_paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like: Tree, values: List[Any]) -> Tree:
    """``like``'s structure with its leaves replaced, in ``leaves`` order,
    by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, Mapping):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more values than leaves")
    return out


__all__ = ["leaves", "leaves_with_paths", "tree_map", "unflatten_like"]
