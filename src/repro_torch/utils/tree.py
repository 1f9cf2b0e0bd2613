"""Flatten and rebuild nested parameter containers.

The counterpart of ``jax.tree_util.tree_flatten`` for the containers the
port uses (dicts, lists, tuples; tensors are leaves). Dict entries are
visited in SORTED key order, as JAX does, so a packed buffer, a flattened
gradient and a parameter dict share one column layout with the reference
(the MLP's ``{"w0", "b0", "w1", "b1"}`` flattens as b0, b1, w0, w1).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

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


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure, as
    ``jax.tree_util.tree_map`` does."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for _, other_def in others:
        if other_def != treedef:
            raise ValueError("tree_map: the trees differ in structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o for o, _ in others))])
