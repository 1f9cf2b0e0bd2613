"""Minimal dependency-free pytree checkpointing, npz + JSON manifest (port
of ``repro/training/checkpoint.py``, in its layout).

Layout:  <dir>/step_<N>/arrays.npz  +  <dir>/step_<N>/manifest.json

The manifest stores the flattened key paths, dtypes and shapes, so restore
rebuilds the exact tree; the keys are the reference's path strings
(``utils.tree.tree_flatten_with_path``: ``params/blocks/0/ff/w_up``,
``opt_state/m/embed``, ``opt_state/step``), and bf16 leaves are written as
fp32 (npz keeps no bf16), so a checkpoint written by either package
restores in the other, bit for bit. Works for params, optimizer state and
the worker momenta alike.

On a mesh (``shardings``: a ``sharding.Placement`` tree matching the
tree, as ``make_train_step``'s ``state["shardings"]`` gives it) each
leaf is gathered by its placement, rank 0 writes, and a barrier follows;
on restore every rank reads the file and keeps its own blocks.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_flatten_with_path, tree_map_with_path


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # npz keeps no bf16: fp32 holds it exactly
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _mesh_of(shardings):
    pls = [pl for _, pl in tree_flatten_with_path(shardings)[0]]
    return pls[0].mesh if pls else None


def save_checkpoint(directory: str, step: int, tree: Any, shardings: Any = None) -> str:
    """Write ``tree`` as ``<directory>/step_<step>``; returns that path.
    With ``shardings`` the leaves are this rank's blocks, gathered here;
    every rank of the mesh calls this (the gathers are collective), and
    rank 0 alone copies the leaves to the host and writes them."""
    path = os.path.join(directory, f"step_{step:08d}")
    placed = dict(tree_flatten_with_path(shardings)[0]) if shardings is not None else {}
    mesh = _mesh_of(shardings) if shardings is not None else None
    writes = mesh is None or mesh.rank == 0
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in tree_flatten_with_path(tree)[0]:
        if key in placed:
            leaf = placed[key].gather(leaf)
        if writes:
            flat[key] = _host(leaf)
    if writes:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like_tree: Any, step: Optional[int] = None,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``like_tree``: each leaf cast to the
    like leaf's dtype, on its device. With ``shardings`` the like leaves
    are this rank's blocks, and each keeps its block of the whole array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    placed = dict(tree_flatten_with_path(shardings)[0]) if shardings is not None else {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = {k for k, _ in tree_flatten_with_path(like_tree)[0]} - set(data.files)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

        def one(key, like):
            arr = torch.from_numpy(np.asarray(data[key]))
            if isinstance(like, torch.Tensor):
                arr = arr.to(device=like.device, dtype=like.dtype)
            if key in placed:
                arr = placed[key].local(arr)
            return arr

        return tree_map_with_path(one, like_tree)
