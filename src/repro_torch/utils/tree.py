"""Flatten and rebuild nested parameter containers.

The counterpart of ``jax.tree_util.tree_flatten`` for the containers the
port uses (dicts, lists, tuples; tensors are leaves). Dict entries are
visited in SORTED key order, as JAX does, so a packed buffer, a flattened
gradient and a parameter dict share one column layout with the reference
(the MLP's ``{"w0", "b0", "w1", "b1"}`` flattens as b0, b1, w0, w1).

Beside them the reference's pytree arithmetic (``tree_add`` ...
``tree_unstack_flat``), so that optimizer and aggregator code reads like
vector algebra; ``tree_dot`` and ``tree_global_norm`` accumulate in fp32.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

_LEAF = "*"


def _walk(node: Any, leaves: List[Any]) -> Any:
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node), tuple(_walk(x, leaves) for x in node))
    leaves.append(node)
    return _LEAF


def _build(node: Any, it) -> Any:
    if node == _LEAF:
        return next(it)
    kind, meta, children = node
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(meta, built))
    return built if kind == "list" else tuple(built)


# The walkers are module functions, not closures: a recursive closure is a
# reference cycle, and the cycle would keep the leaves alive until Python's
# cyclic collector ran (tens of GB at full width).
def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is a hashable description."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure, as
    ``jax.tree_util.tree_map`` does."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for _, other_def in others:
        if other_def != treedef:
            raise ValueError("tree_map: the trees differ in structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o for o, _ in others))])


# --------------------------------------------------------------- arithmetic
def _leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Any, scalar) -> Any:
    return tree_map(lambda x: x * scalar, a)


def tree_axpy(alpha, x: Any, y: Any) -> Any:
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Global dot product across all leaves (fp32 accumulation)."""
    return sum(torch.vdot(x.float().reshape(-1), y.float().reshape(-1))
               for x, y in zip(_leaves(a), _leaves(b)))


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm across all leaves (fp32 accumulation)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def tree_size(tree: Any) -> int:
    """Total number of scalar parameters in the tree."""
    return sum(int(x.numel()) for x in _leaves(tree))


def tree_stack_flat(tree: Any) -> Tuple[torch.Tensor, Callable]:
    """Flatten every leaf and concatenate into a single 1-D vector.

    Returns (vector, unflatten_fn). Used where the whole model fits on one
    device; the packed sync keeps its own padded layout
    (``distributed/packing.py``)."""
    leaves, treedef = tree_flatten(tree)
    shapes = [x.shape for x in leaves]
    sizes = [int(x.numel()) for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves]) if leaves else torch.zeros((0,))

    def unflatten(vec: torch.Tensor) -> Any:
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(vec[off:off + size].reshape(shape))
            off += size
        return tree_unflatten(treedef, out)

    return flat, unflatten


def tree_unstack_flat(vec: torch.Tensor, like_tree: Any) -> Any:
    """Inverse of tree_stack_flat given a template tree."""
    _, unflatten = tree_stack_flat(like_tree)
    return unflatten(vec)
