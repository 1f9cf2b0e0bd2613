"""Byzantine-robust gradient synchronisation: the paper's technique as the
distributed gradient sync (it replaces the mean all-reduce over workers).

Port of ``repro/distributed/robust_sync.py``. Two engines:

- ``engine="packed"`` (default): the whole gradient tree flattened once
  into a padded ``[W, n_pad]`` fp32 buffer and run through the kernels
  (``packing.py``), on one device or sharded by columns over a process
  group (``shard_kernels.py``).
- ``engine="per_leaf"``: each leaf contracted on its own (Gram, mixing,
  combine per leaf), kept as the bit-exactness oracle of the packed engine.
  With ``use_kernels=True`` each leaf goes to the kernels as ``[W, N_leaf]``
  in its own dtype (fp32, bf16 or fp16: the kernels convert at the load,
  exactly, as the reference's do), with no fp32 copy; its Gram chains
  through the Gram kernel's
  fixed 2048-column tiles (``acc``), the same sum as the packed engine's
  one call, so on one device the two engines agree bit for bit. With the
  default ``use_kernels=False`` it runs plain PyTorch contractions. Over a
  group of ranks its kernel route slices each leaf's ``[W, N_leaf]``
  columns over all ranks (the reference's ``_colshard``) and runs the
  sharded kernels of ``shard_kernels.py`` on them: the mix, the Gram
  chained leaf to leaf through ``acc`` and all-reduced once, CM and TM,
  the combine; each leaf's result is replicated and, with
  ``out_shardings``, cut to this rank's block. Column-local rules (CM, TM)
  equal the packed engine's over the group bit for bit. The plain route
  runs the one-device contractions on every rank.

Semantics equal ``RobustAggregator`` on the stacked vector.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import packing, shard_kernels
from repro_torch.kernels import ops
from repro_torch.launch.mesh import as_mesh
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def _flat32(leaf: torch.Tensor, n_workers: int) -> torch.Tensor:
    return leaf.reshape(n_workers, -1).float().contiguous()


def _rows(leaf: torch.Tensor, n_workers: int) -> torch.Tensor:
    """A leaf's ``[W, N_leaf]`` stack in its own dtype: what the kernels take."""
    return leaf.reshape(n_workers, -1).contiguous()


def _tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


def _columns(leaf: torch.Tensor, n_workers: int, group) -> torch.Tensor:
    """A leaf's ``[W, N_leaf]`` stack in its own dtype (``_rows``), or over a
    group this rank's column slice of it (zero-padded in that dtype)."""
    flat = _rows(leaf, n_workers)
    return flat if group is None else shard_kernels.shard_cols(flat, group)


def _whole(out: torch.Tensor, n: int, group) -> torch.Tensor:
    """A column-sharded ``[n]`` result replicated (no-op without a group)."""
    return out if group is None else shard_kernels.unshard_cols(out, n, group)


def tree_gram(grads_w: Any, n_workers: int, use_kernels: bool = False,
              group=None) -> torch.Tensor:
    """Sum over leaves of per-leaf worker Gram matrices -> ``[W, W]`` fp32.

    With ``use_kernels`` the per-leaf contributions chain through the Gram
    kernel's fixed tiles with a carried ``acc``: the packed engine's sum;
    over a ``group`` each rank chains its column slices, then one
    all-reduce adds the ranks' partial Grams."""
    leaves, _ = tree_flatten(grads_w)
    gram = torch.zeros((n_workers, n_workers), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        if leaf.numel() == 0:
            continue
        if use_kernels:
            gram = ops.gram(_columns(leaf, n_workers, group), acc=gram)
        else:
            flat = _flat32(leaf, n_workers)
            gram = gram + flat @ flat.T
    if use_kernels and group is not None:
        gram = shard_kernels.all_reduced(gram, group)
    return gram


def tree_combine(grads_w: Any, weights: torch.Tensor, use_kernels: bool = False,
                 group=None) -> Any:
    """Per-leaf weighted combination over the worker axis."""
    def one(leaf):
        if leaf.numel() == 0:  # guard BEFORE reshape(W, -1)
            return torch.zeros(leaf.shape[1:], dtype=leaf.dtype, device=leaf.device)
        if use_kernels:
            w, local = weights[None, :].contiguous(), _columns(leaf, leaf.shape[0], group)
            mixed = (ops.mix_apply(w, local) if group is None
                     else shard_kernels.mix_apply(w, local, group))
            out = _whole(mixed[0], leaf[0].numel(), group)
        else:
            out = weights @ _flat32(leaf, leaf.shape[0])
        return out.reshape(leaf.shape[1:]).to(leaf.dtype)

    return _tree_map(one, grads_w)


def tree_mix(grads_w: Any, mix_matrix: torch.Tensor, use_kernels: bool = False) -> Any:
    """Apply the mixing operator leaf-wise: ``[W, ...] -> [m, ...]``."""
    m = mix_matrix.shape[0]

    def one(leaf):
        if leaf.numel() == 0:  # guard BEFORE reshape(W, -1)
            return torch.zeros((m,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                               device=leaf.device)
        out = (ops.mix_apply(mix_matrix, _rows(leaf, leaf.shape[0])) if use_kernels
               else mix_matrix @ _flat32(leaf, leaf.shape[0]))
        return out.reshape((m,) + tuple(leaf.shape[1:])).to(leaf.dtype)

    return _tree_map(one, grads_w)


def _per_leaf_sync(grads_w: Any, aggregator: RobustAggregator, mix: torch.Tensor,
                   use_kernels: bool, telemetry: bool = False,
                   group=None) -> Tuple[Any, dict]:
    """The per-leaf engine (module docstring); ``group``: the ranks the
    kernel route's columns are sliced over (``None``: one device).

    ``telemetry=True`` adds ``info["telemetry"]`` from the Gram-space probes
    (non-coordinatewise rules only — the coordinatewise route has no stacked
    buffer to probe without materializing one; use the packed engine for
    CM/TM telemetry)."""
    leaves, _ = tree_flatten(grads_w)
    n_workers = leaves[0].shape[0]
    info: dict = {}
    base = aggregator.base
    group = group if use_kernels else None

    if base.coordinatewise:
        if not use_kernels:
            return _tree_map(base.combine_leaf, tree_mix(grads_w, mix)), info

        # kernel route: each leaf in its own dtype into the mix, fp32 after
        # it, CM/TM through their kernels, phase for phase the packed engine's
        def one(leaf):
            if leaf.numel() == 0:  # guard BEFORE reshape(W, -1)
                return torch.zeros(leaf.shape[1:], dtype=leaf.dtype, device=leaf.device)
            local = _columns(leaf, n_workers, group)
            if group is None:
                mixed = ops.mix_apply(mix, local)
                if base.name == "cm":
                    out = ops.cm_aggregate(mixed)
                elif base.name == "tm":
                    out = ops.tm_aggregate(mixed, min(base.n_trim, (mixed.shape[0] - 1) // 2))
                else:
                    out = base.combine_leaf(mixed)
            else:
                mixed = shard_kernels.mix_apply(mix, local, group)
                if base.name == "cm":
                    out = shard_kernels.cm_aggregate(mixed, group)
                elif base.name == "tm":
                    out = shard_kernels.tm_aggregate(
                        mixed, min(base.n_trim, (mixed.shape[0] - 1) // 2), group)
                else:
                    out = shard_kernels.coordinatewise_combine(mixed, group, base.combine_leaf)
                out = _whole(out, leaf[0].numel(), group)
            return out.reshape(leaf.shape[1:]).to(leaf.dtype)

        return _tree_map(one, grads_w), info

    gram = tree_gram(grads_w, n_workers, use_kernels=use_kernels, group=group)
    if telemetry:
        weights, info["telemetry"] = aggregator.worker_weights_and_stats_from_gram(gram, mix=mix)
    else:
        weights = aggregator.worker_weights_from_gram(gram, mix=mix)
    info["agg_weights"] = weights
    info["gram_diag_mean"] = torch.mean(torch.diagonal(gram))
    return tree_combine(grads_w, weights, use_kernels=use_kernels, group=group), info


def robust_gradient_sync(
    grads_w: Any,
    aggregator: RobustAggregator,
    mix: Optional[torch.Tensor] = None,
    mesh=None,
    engine: str = "packed",
    use_kernels: Optional[bool] = None,
    out_shardings: Any = None,
    telemetry: bool = False,
    worker_sharded: bool = False,
    in_shardings: Any = None,
) -> Tuple[Any, dict]:
    """Aggregate per-worker gradient trees (leaves ``[W, ...]``) into one
    gradient tree, using mixing + the robust rule. Returns ``(grads, info)``.

    ``mix`` is the round's ``[m, W]`` mixing matrix (identity permutation
    without it); over a group every rank passes the same one. ``mesh`` is
    ``None`` or a ``torch.distributed`` process group (``launch/mesh.py``).
    ``use_kernels=None`` resolves to the kernels for the packed engine and
    to plain PyTorch for the per-leaf engine. ``out_shardings`` (a
    ``sharding.Placement`` tree) returns this rank's blocks of the result:
    the param-sharded egress. ``telemetry=True``
    adds the metrics as ``info["telemetry"]`` (``packing.py``).
    ``worker_sharded=True``: over a group each rank passes only its own
    workers' rows, with ``in_shardings`` its blocks of them
    (``packing.packed_robust_sync``)."""
    if engine == "packed":
        return packing.packed_robust_sync(
            grads_w, aggregator, mix=mix, mesh=mesh,
            use_kernels=True if use_kernels is None else use_kernels,
            out_shardings=out_shardings, telemetry=telemetry,
            worker_sharded=worker_sharded, in_shardings=in_shardings)
    if engine != "per_leaf":
        raise ValueError(f"unknown sync engine {engine!r}")
    if worker_sharded:
        raise NotImplementedError("worker-sharded rows go through the packed engine")
    group = None if packing._mesh_is_trivial(mesh) else as_mesh(mesh).group
    leaves, _ = tree_flatten(grads_w)
    device = leaves[0].device
    mix = (aggregator.mixer.matrix(leaves[0].shape[0], device=device) if mix is None
           else mix.to(device=device, dtype=torch.float32).contiguous())
    out, info = _per_leaf_sync(grads_w, aggregator, mix, bool(use_kernels),
                               telemetry=telemetry, group=group)
    if out_shardings is not None and mesh is not None:  # ignored without a mesh
        out = tree_map(lambda g, pl: pl.local(g), out, out_shardings)
    return out, info
