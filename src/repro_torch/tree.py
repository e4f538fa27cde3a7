"""Nested dicts of tensors as the reference's pytrees.

The trainer keeps its state in the reference's layout: nested dicts whose
leaves are tensors, listed in ``jax.tree.leaves`` order (dict keys sorted,
lists in order), so a leaf index means the same leaf in both packages
(``sync.chunk_assignment`` shards by it).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, unflatten): ``unflatten(new_leaves)`` rebuilds the structure
    with ``new_leaves`` in leaf order."""
    flat = leaves(tree)

    def build(node, it):
        if isinstance(node, dict):
            return {k: build(node[k], it) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t, it) for t in node)
        return next(it)

    return flat, lambda new: build(tree, iter(new))


def map(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of trees of one structure."""
    flat, unflatten = flatten(tree)
    others = [leaves(t) for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} leaves "
                             f"against {len(o)}")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
