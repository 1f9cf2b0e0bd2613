"""Flatten helpers of ``repro/training/byzantine.py``.

This slice carries ``stack_flatten_workers`` and ``unflatten_like``, which
the cross-device loop uses; ``ByzantineSim`` joins in a later slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten


def stack_flatten_workers(tree) -> torch.Tensor:
    """Stacked grad tree (leaves [W, ...]) -> [W, d], leaves in the
    reference's order."""
    leaves, _ = tree_flatten(tree)
    W = leaves[0].shape[0]
    return torch.cat([x.reshape(W, -1) for x in leaves], dim=1)


def unflatten_like(vec: torch.Tensor, tree) -> Any:
    leaves, treedef = tree_flatten(tree)
    out, off = [], 0
    for leaf in leaves:
        size = leaf.numel()
        out.append(vec[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(treedef, out)
