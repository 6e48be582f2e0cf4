"""Nested containers of tensors (the port's pytrees).

A tree is a dict, list or tuple whose leaves are tensors, arrays, numbers
or partition specs.  Leaves are visited in the JAX package's pytree order: dict keys
sorted, sequences by index.  That order fixes the checkpoint's leaf names
(``checkpoint/store.py``) and the summation order of ``optim.global_norm``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _children(tree) -> List[Tuple[Any, Any]]:
    if is_leaf(tree):
        return []
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def is_leaf(tree) -> bool:
    """Containers are plain dicts, lists and tuples; a subclass of one (a
    partition spec ``core.mesh.P``) is a leaf."""
    return type(tree) not in (dict, list, tuple)


def leaves_with_path(tree: Tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in pytree order; a path is the tuple of dict keys and
    sequence indices from the root."""
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out += leaves_with_path(child, prefix + (k,))
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilt in ``tree``'s structure."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError(f"tree_map: dict keys differ: {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if any(len(r) != len(tree) for r in rest):
        raise ValueError(f"tree_map: sequence lengths differ from {len(tree)}")
    return type(tree)(tree_map(fn, *(t[i] for t in (tree,) + rest))
                      for i in range(len(tree)))


def tree_unflatten(like: Tree, new_leaves) -> Tree:
    """``like``'s structure with ``new_leaves`` (in pytree order) as leaves."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out
