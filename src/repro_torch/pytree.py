"""Nested dicts of tensors: the param, optimizer and checkpoint trees.

The LM substrate keeps its state as the reference's pytrees do: nested
``dict``s whose leaves are tensors (or arrays).  Leaves are visited in
sorted key order, as JAX flattens a dict, so a path list, a checkpoint's
array names and its manifest come out in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[("a/b/c", leaf), ...]`` in sorted key order; ``None`` is no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}{k}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(paths: list[str], values: list) -> dict:
    """The nested dict whose leaf at each ``a/b/c`` path is its value."""
    root: dict = {}
    for path, v in zip(paths, values):
        node = root
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return root
