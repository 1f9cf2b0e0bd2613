"""Train and serving-prefill steps (port of ``repro/distributed/steps.py``).

Workers are data-parallel groups: the global batch's leading axis splits
into W worker shards; each worker's gradient comes from one forward and
backward of ``loss_fn`` on its rows (a Python loop over the workers: the
reference's ``vmap`` would hold every worker's activations at once), with
no cross-worker reduction. The paper's mixing + robust aggregation then
REPLACES the gradient all-reduce (``robust_gradient_sync`` with the packed
engine and its kernels), and the optimizer update runs.

``mesh=None`` runs all W workers on one device. Over a
``torch.distributed`` group of R ranks (``launch/mesh.py``) rank r runs
workers ``r W/R .. (r+1) W/R - 1`` and keeps only their momenta; the
packed sync takes the rows worker-sharded (one ``all_to_all`` in), runs
the sharded kernels on column slices (``shard_kernels.py``) and
replicates the aggregate (one all-reduce out), and every rank applies the
same optimizer update to its replicated parameters.

Momentum modes (the reference's DESIGN.md §5):
  worker : Algorithm 2, per-worker momentum leaves [W, ...] (fp32)
  server : Remark 7, raw per-worker grads robust-aggregated, momentum in
           the optimizer state.

FSDP configs (``cfg.fsdp``) run on one rank: there the reference's
param-sharded egress places every leaf whole, so the step is the
replicated one, bit for bit. Not ported: that egress over R > 1 ranks
(``packing.unpack_to_shardings``), the mesh-sharded prefill and the decode
step; they raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.launch.mesh import n_devices
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer
from repro_torch.telemetry import phase
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


# ------------------------------------------------------------- input specs
class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (``jax.ShapeDtypeStruct``'s place)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg, shape) -> Dict[str, TensorSpec]:
    """Stand-ins for every model input of this ``InputShape``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        tok = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
        specs = {"tokens": TensorSpec(tok, i32), "labels": TensorSpec(tok, i32)}
        if cfg.n_prefix_tokens:
            specs["prefix_embeds"] = TensorSpec((B, cfg.n_prefix_tokens, cfg.d_model),
                                                getattr(torch, cfg.dtype))
        return specs
    # decode: ONE new token against a seq_len cache
    return {"token": TensorSpec((B, cfg.n_codebooks) if cfg.n_codebooks else (B,), i32)}


# -------------------------------------------------------------- train step
def make_train_step(
    cfg,
    byz,
    mesh=None,
    lr: float = 1e-3,
    optimizer: str = "sgdm",
    telemetry: bool = False,
    n_workers: int = 0,
    device=None,
) -> Tuple[Callable, Dict[str, Any]]:
    """Returns ``(step_fn, state)`` where
    ``step_fn(params, opt_state, worker_m, mix, batch) ->
    (params, opt_state, worker_m, metrics)``.

    ``n_workers`` is W (0: one worker a rank). ``mix`` is the round's
    ``[m, W]`` mixing matrix (``aggregator.mixing_matrix``), the same on
    every rank, in the place of the reference's ``key``; ``None`` is the
    reference's ``key=None`` (the identity permutation). ``batch`` holds
    the global ``[B_global, ...]`` "tokens" and "labels" on every rank.
    ``worker_m`` (this rank's workers, leaves ``[W/R, ...]`` fp32; ``{}``
    when worker momentum is off) is updated in place, as the optimizer's
    moments are (``optim/optimizers.py``), and returned. ``metrics`` holds
    the mean loss over all W workers and, with ``telemetry=True``, the
    sync's metrics under ``"telemetry"``.

    ``state["worker_m"]`` describes the worker momenta (``{}`` when off, so
    ``if state["worker_m"]`` reads as in the reference);
    ``state["init_params"](generator)``, ``state["init_opt_state"](params)``
    and ``state["init_worker_m"](params)`` build the arguments in the
    reference's shapes on ``device``."""
    dev = resolve_device(device)
    R = 1 if mesh is None else n_devices(mesh)
    W = n_workers or R
    if W % R:
        raise ValueError(f"{W} workers do not split over {R} ranks")
    if cfg.fsdp and R > 1:
        raise NotImplementedError("the param-sharded egress (FSDP) over more than one rank is "
                                  "queued in ROADMAP.md, Queue 1")
    w_local = W // R
    first = 0 if R == 1 else dist.get_rank(mesh) * w_local
    aggregator = byz.make_aggregator(W)
    opt_init, opt_update = make_optimizer(optimizer, lr=lr, beta1=byz.worker_momentum or 0.9,
                                          m_dtype=cfg.opt_m_dtype)
    use_worker_momentum = cfg.momentum_mode == "worker" and byz.worker_momentum > 0
    is_plain_mean = byz.aggregator in ("mean", "avg") and byz.mixing in ("none", "")
    beta = byz.worker_momentum

    def worker_batches(batch):
        """This rank's workers' rows: ``[B_global, ...] -> [W, b_local, ...]``
        as the reference's ``split_workers``, then workers ``first ..``."""
        split = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=dev)
            split[k] = v.reshape((W, v.shape[0] // W) + tuple(v.shape[1:]))
        return [{k: v[w] for k, v in split.items()} for w in range(first, first + w_local)]

    def one_worker(p_live, live, b):
        """``(loss, grads)`` of one worker: a forward and backward of
        ``loss_fn``, whose activations are freed when it returns."""
        with phase("forward_backward"):
            loss, _ = tfm.loss_fn(p_live, cfg, b)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        return loss.detach(), grads

    def mean_loss(losses):
        if R == 1:
            return torch.mean(torch.stack(losses))
        total = torch.sum(torch.stack(losses))
        dist.all_reduce(total, group=mesh)
        return total / W

    def step_fn(params, opt_state, worker_m, mix, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        p_live = tree_unflatten(treedef, live)
        losses = []
        if is_plain_mean and not use_worker_momentum:
            # BASELINE: the mean gradient over all W workers (the paper's Avg),
            # summed in fp32 over this rank's workers, then over the ranks
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for b in worker_batches(batch):
                loss, grads = one_worker(p_live, live, b)
                losses.append(loss)
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
            if R > 1:
                for a in acc:
                    dist.all_reduce(a, group=mesh)
            agg_grads = tree_unflatten(treedef, [(a / W).to(p.dtype)
                                                 for a, p in zip(acc, leaves)])
            del acc
            info = {}
        else:
            if use_worker_momentum:
                rows = tree_flatten(worker_m)[0]
            else:  # server momentum: the raw per-worker gradients are the messages
                rows = [torch.empty((w_local,) + tuple(p.shape), dtype=p.dtype, device=p.device)
                        for p in leaves]
            for w, b in enumerate(worker_batches(batch)):
                loss, grads = one_worker(p_live, live, b)
                losses.append(loss)
                with phase("worker_momentum"):
                    for row, g in zip(rows, grads):
                        if use_worker_momentum:  # beta m + (1 - beta) g, in place
                            row[w].mul_(beta).add_((1.0 - beta) * g.float())
                        else:
                            row[w].copy_(g)
                del grads
            messages = worker_m if use_worker_momentum else tree_unflatten(treedef, rows)
            del rows
            with phase("sync"):
                agg_grads, info = robust_gradient_sync(
                    messages, aggregator, mix=mix, mesh=mesh, engine="packed",
                    telemetry=telemetry, worker_sharded=R > 1)
            del messages
        del live, p_live
        with phase("optimizer"):
            params, opt_state = opt_update(agg_grads, opt_state, params)
        metrics = {"loss": mean_loss(losses)}
        if telemetry and "telemetry" in info:
            metrics["telemetry"] = info["telemetry"]
        return params, opt_state, worker_m, metrics

    def init_worker_m(params):
        if not use_worker_momentum:
            return {}
        return tree_map(lambda p: torch.zeros((w_local,) + tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)

    state = {
        "worker_m": {"rows": w_local, "dtype": torch.float32} if use_worker_momentum else {},
        "workers": (first, first + w_local),
        "aggregator": aggregator,
        "init_params": lambda generator: tfm.init_params(cfg, generator, device=dev),
        "init_opt_state": opt_init,
        "init_worker_m": init_worker_m,
    }
    return step_fn, state


# ------------------------------------------------------------ prefill step
def make_prefill_step(cfg, mesh=None, last_only: bool = True, device=None) -> Callable:
    """Serving prefill: ``prefill(params, batch) -> fp32 logits``.
    ``last_only`` (default) unembeds ONLY the final position, the next-token
    logits a server needs ([B, 1, V]); the full-sequence [B, S, V] fp32
    logits would dominate peak memory. ``batch["tokens"]`` ([B, S] ints) is
    moved to ``device``, where the parameters must lie."""
    if mesh is not None:
        raise NotImplementedError("a sharded prefill is queued in ROADMAP.md, Queue 1")
    dev = resolve_device(device)

    def prefill(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        h, _ = tfm.forward_hidden(params, cfg, tokens, prefix_embeds=batch.get("prefix_embeds"))
        if last_only:
            h = h[:, -1:]
        return tfm.unembed(params, cfg, h)

    return prefill
