"""Flatten and rebuild nested parameter containers.

The counterpart of ``jax.tree_util.tree_flatten`` for the containers the
port uses (dicts, lists, tuples; tensors are leaves). Dict entries are
visited in SORTED key order, as JAX does, so a packed buffer, a flattened
gradient and a parameter dict share one column layout with the reference
(the MLP's ``{"w0", "b0", "w1", "b1"}`` flattens as b0, b1, w0, w1).
"""

from __future__ import annotations

from typing import Any, List, Tuple

_LEAF = "*"


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is a hashable description."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(walk(x) for x in node))
        leaves.append(node)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if node == _LEAF:
            return next(it)
        kind, meta, children = node
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        return built if kind == "list" else tuple(built)

    return build(treedef)
