"""Flatten and rebuild nested parameter containers.

The counterpart of ``jax.tree_util.tree_flatten`` for the containers the
port uses (dicts, lists, tuples; tensors are leaves). Dict entries are
visited in SORTED key order, as JAX does, so a packed buffer, a flattened
gradient and a parameter dict share one column layout with the reference
(the MLP's ``{"w0", "b0", "w1", "b1"}`` flattens as b0, b1, w0, w1).

``tree_flatten_with_path`` and ``tree_map_with_path`` name every leaf
by the reference's path string: the ``"/".join`` of dict keys, list
indices and NamedTuple field names (``blocks/0/ff/w_up``, ``m/embed``,
``step``), as ``jax.tree_util``'s key paths print in the reference's
sharding rules and checkpoints. All of them walk a tree alike: ``None``
is an empty subtree and a NamedTuple keeps its type, as in JAX.

Beside them the reference's pytree arithmetic (``tree_add`` ...
``tree_unstack_flat``), so that optimizer and aggregator code reads like
vector algebra; ``tree_dot`` and ``tree_global_norm`` accumulate in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

_LEAF = "*"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that need not exist (the place of
    ``jax.ShapeDtypeStruct``); a leaf of a tree, not a container."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_specs(tree: Any) -> Any:
    """The ``TensorSpec`` of every tensor leaf."""
    return tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype), tree)


def _walk(node: Any, prefix: Tuple[str, ...], items: List[Tuple[str, Any]]) -> Any:
    """``node``'s treedef; its ``(path, leaf)`` pairs appended to ``items``."""
    if node is None:
        return ("none", None, ())
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], prefix + (str(k),), items) for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (type(node), None, tuple(_walk(getattr(node, f), prefix + (f,), items)
                                        for f in node._fields))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node), tuple(_walk(x, prefix + (str(i),), items)
                                       for i, x in enumerate(node)))
    items.append(("/".join(prefix), node))
    return _LEAF


def _build(node: Any, it) -> Any:
    if node == _LEAF:
        return next(it)
    kind, meta, children = node
    built = [_build(c, it) for c in children]
    if kind == "none":
        return None
    if kind == "dict":
        return dict(zip(meta, built))
    if kind == "list":
        return built
    return tuple(built) if kind == "tuple" else kind(*built)


# The walkers are module functions, not closures: a recursive closure is a
# reference cycle, and the cycle would keep the leaves alive until Python's
# cyclic collector ran (tens of GB at full width).
def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path, leaf), ...], treedef)`` in the reference's leaf order
    (dict keys sorted), each path the reference's string (module
    docstring); ``treedef`` is a hashable description."""
    items: List[Tuple[str, Any]] = []
    treedef = _walk(tree, (), items)
    return items, treedef


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``, as ``jax.tree_util.tree_flatten``."""
    items, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in items], treedef


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


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` leaf by leaf, as ``jax.tree_util.tree_map_with_path``
    with the path as the reference's string."""
    items, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [fn(path, leaf) for path, leaf in items])


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
