"""Train, serving-prefill and decode steps (port of
``repro/distributed/steps.py``).

Workers are data-parallel groups: the global batch's leading axis splits
into W worker shards; each worker's gradient comes from one forward and
backward of ``loss_fn`` on its rows (a Python loop over the workers: the
reference's ``vmap`` would hold every worker's activations at once), with
no cross-worker reduction. For the backward, autograd keeps every layer's
activations, or for a ``remat="full"`` config only each period's input,
the period recomputed when the backward reaches it
(``transformer.forward_hidden``). The paper's mixing + robust aggregation then
REPLACES the gradient all-reduce (``robust_gradient_sync`` with the packed
engine and its kernels), and the optimizer update runs.

``mesh=None`` runs all W workers on one device. Over a mesh of R ranks
(``launch/mesh.py``: a ``Mesh``, or a bare ``torch.distributed`` group,
the mesh ``("data",)``) the workers split over the worker axes (``pod``,
``data``): the G = ``n_workers(mesh)`` worker groups run workers
``g W/G .. (g+1) W/G - 1`` each, every rank of a group (its ``model``
ranks) the same ones.

Parameters live as the placements of ``sharding.param_shardings(...,
fsdp=cfg.fsdp, overrides=overrides_from_config(cfg))`` say
(``state["shardings"]["params"]``): each rank holds only its blocks of the
parameters and of the optimizer moments (the step counter replicated).
The forward and backward run on compute blocks, placed by the compute
plan ``sharding.compute_shardings`` (``state["shardings"]["compute"]``): a
step gathers each leaf, keeps its compute block and frees the whole leaf
before the next. Where the ``model`` axis has T > 1 ranks the ranks of a
worker group compute along it (``models/parallel.py``: heads, d_ff, vocab
and a MoE layer's experts split where T divides them, all-reduces over
the model group), so each holds its blocks' activations, gradients and
worker momenta only (a MoE layer's E/T experts; its router, held whole
by the group, is sent to the sync by model coordinate 0 alone); with
T = 1 the compute blocks are the whole leaves. The packed sync takes
the rows worker-sharded and runs the sharded kernels on column slices
over all R ranks (``shard_kernels.py``): with T = 1 one ``all_to_all`` of
whole rows from the ranks at model coordinate 0
(``shard_kernels.rows_to_cols``), over a model axis one ``all_to_all`` in
which each rank sends each column owner the elements of its compute
blocks (``packing.pack_from_shardings``; a leaf held whole by a model
group is sent by coordinate 0). The egress is the param-sharded
``unpack_to_shardings`` for an fsdp config, the replicated row (then cut)
for any other, as in the reference; and the optimizer, elementwise,
updates the blocks.

Serving: ``make_prefill_step`` splits the batch rows over the worker axes
(``batch_shardings``), and each rank prefills its own. ``make_serve_step``
decodes one token against a cache placed by ``sharding.cache_shardings``:
batch-sharded (each rank its own rows), or for a batch smaller than the
workers sequence-sharded over ``data`` with the heads over ``model``,
where each rank attends over its own positions and the partial softmax
statistics are combined across ranks (``_softmax_across``). Where the
``model`` axis has T > 1 ranks both steps take this rank's compute blocks
of the parameters (``sharding.compute_blocks``), as the reference's
jitted steps take its model-sharded parameters: the ranks of a model
group compute along it (``models/parallel.py``), and every one of them
returns the logits of all V.

Momentum modes (the reference's DESIGN.md §5):
  worker : Algorithm 2, per-worker momentum leaves [W, ...] (fp32), each
           rank of the worker's group holding its compute blocks
  server : Remark 7, raw per-worker grads robust-aggregated, momentum in
           the optimizer state.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.distributed.sharding import (Placement, batch_spec, cache_shardings,
                                              compute_shardings, gather_many,
                                              overrides_from_config, param_shardings,
                                              ssm_segments)
from repro_torch.launch.mesh import as_mesh, worker_axes
from repro_torch.launch.mesh import n_workers as mesh_n_workers
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.parallel import ModelAxis
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import OptState
from repro_torch.telemetry import phase
from repro_torch.utils.tree import (TensorSpec, tree_flatten, tree_flatten_with_path, tree_map,
                                    tree_map_with_path, tree_unflatten)


# ------------------------------------------------------------- input specs
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


def _rows_entry(mesh, n: int):
    """The spec entry of a batch dim of ``n`` rows: the worker axes where
    the worker groups divide it, else ``None`` (every rank all rows)."""
    G = mesh_n_workers(mesh)
    return batch_spec(mesh)[0] if n % G == 0 and n >= G else None


def batch_shardings(cfg, shape, mesh) -> Dict[str, Placement]:
    """A ``Placement`` for every model input of this ``InputShape``: the
    batch dim over the worker axes where they divide it."""
    return {k: Placement(mesh, (_rows_entry(mesh, v.shape[0]),) + (None,) * (len(v.shape) - 1))
            for k, v in input_specs(cfg, shape).items()}


def gather_batch(local: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The whole ``[batch, ...]`` tensor on every rank from each rank's rows
    (a prefill's or decode step's logits), as ``batch_shardings`` split the
    ``batch`` rows."""
    pl = Placement(as_mesh(mesh), (_rows_entry(as_mesh(mesh), batch),))
    return pl.gather(local)


def _worker_group(mesh) -> int:
    """This rank's worker-group index: its coordinates on the worker axes,
    row-major."""
    g = 0
    for a in worker_axes(mesh):
        g = g * mesh.shape[a] + mesh.coords[a]
    return g


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

    ``n_workers`` is W (0: one worker a worker group). ``mix`` is the
    round's ``[m, W]`` mixing matrix (``aggregator.mixing_matrix``), the
    same on every rank, in the place of the reference's ``key``; ``None``
    is the reference's ``key=None`` (the identity permutation). ``batch``
    holds the global ``[B_global, ...]`` "tokens" and "labels" on every
    rank. ``params`` and ``opt_state`` are this rank's blocks
    (``state["shardings"]``; whole tensors without a mesh). ``worker_m``
    (this rank's workers' compute blocks, leaves ``[W/G, ...]`` fp32; ``{}``
    when worker momentum is off) is updated in place, as the optimizer's moments are
    (``optim/optimizers.py``), and returned. ``metrics`` holds the mean
    loss over all W workers and, with ``telemetry=True``, the sync's
    metrics under ``"telemetry"``.

    ``state["worker_m"]`` describes the worker momenta (``{}`` when off, so
    ``if state["worker_m"]`` reads as in the reference);
    ``state["init_params"](generator)``, ``state["init_opt_state"](params)``
    and ``state["init_worker_m"](params)`` build the arguments on
    ``device``, this rank's blocks of them on a mesh;
    ``state["shardings"]`` (``None`` without a mesh) holds the
    ``Placement`` trees of ``params``, ``opt_state`` and ``worker_m``, the
    compute plan ``compute`` and ``params_shape``, the ``TensorSpec``
    tree."""
    dev = resolve_device(device)
    m = None if mesh is None else as_mesh(mesh)
    G = 1 if m is None else mesh_n_workers(m)
    W = n_workers or G
    if W % G:
        raise ValueError(f"{W} workers do not split over {G} ranks' worker groups")
    w_local = W // G
    first = 0 if m is None else _worker_group(m) * w_local
    # the ranks at model coordinate 0 speak for their worker group in sums
    speaks = m is None or not m.coords.get("model", 0)
    aggregator = byz.make_aggregator(W)
    opt_init, opt_update = make_optimizer(optimizer, lr=lr, beta1=byz.worker_momentum or 0.9,
                                          m_dtype=cfg.opt_m_dtype)
    use_worker_momentum = cfg.momentum_mode == "worker" and byz.worker_momentum > 0
    is_plain_mean = byz.aggregator in ("mean", "avg") and byz.mixing in ("none", "")
    beta = byz.worker_momentum
    params_shape = None if m is None else tfm.params_shape(cfg)
    placements = None if m is None else param_shardings(
        params_shape, m, fsdp=cfg.fsdp, overrides=overrides_from_config(cfg))
    # the compute plan: each leaf's block this rank's forward and backward
    # run on (whole leaves where the model axis has one rank)
    compute = None if m is None else compute_shardings(cfg, params_shape, m)
    ax = None if m is None else ModelAxis.of(cfg, m)
    # over a model axis the rows and worker momenta are compute blocks
    in_blocks = compute if ax is not None else None
    # the param-sharded egress for fsdp configs; the replicated row, then
    # cut, for the rest (the reference's egress_sh)
    egress = placements if (cfg.fsdp and m is not None and m.size > 1) else None

    def blocks(tree):
        return tree if placements is None else tree_map(lambda x, pl: pl.local(x), tree,
                                                        placements)

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
            loss, _ = tfm.loss_fn(p_live, cfg, b, ax=ax)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        return loss.detach(), grads

    def group_sum(t):
        """``t`` summed over the worker groups (in place)."""
        if m is not None and m.size > 1:
            if not speaks:
                t.zero_()
            dist.all_reduce(t, group=m.group)
        return t

    def step_fn(params, opt_state, worker_m, mix, batch):
        with phase("gather"):
            # each leaf gathered, its compute block kept, the whole leaf
            # freed before the next
            own = params if placements is None else tree_map(
                lambda b, pl, cpl: cpl.local(pl.gather(b)), params, placements, compute)
        leaves, treedef = tree_flatten(own)
        del own
        live = [p.detach().requires_grad_() for p in leaves]
        p_live = tree_unflatten(treedef, live)
        losses = []
        if is_plain_mean and not use_worker_momentum:
            # BASELINE: the mean gradient over all W workers (the paper's Avg),
            # summed in fp32 over this rank's workers, then over the groups
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for b in worker_batches(batch):
                loss, grads = one_worker(p_live, live, b)
                losses.append(loss)
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
            del live, p_live
            if ax is not None:  # the compute blocks' sums, whole
                acc = [cpl.gather(a) for a, cpl in zip(acc, tree_flatten(compute)[0])]
            agg_grads = blocks(tree_unflatten(treedef, [
                (group_sum(a) / W).to(p.dtype) for a, p in zip(acc, leaves)]))
            del acc, leaves
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
            del live, p_live, leaves  # the gathered parameters
            messages = worker_m if use_worker_momentum else tree_unflatten(treedef, rows)
            del rows
            with phase("sync"):
                agg_grads, info = robust_gradient_sync(
                    messages, aggregator, mix=mix, mesh=m, engine="packed",
                    out_shardings=egress, telemetry=telemetry,
                    worker_sharded=m is not None and m.size > 1, in_shardings=in_blocks)
            del messages
            if egress is None:
                agg_grads = blocks(agg_grads)
        with phase("optimizer"):
            params, opt_state = opt_update(agg_grads, opt_state, params)
        metrics = {"loss": group_sum(torch.sum(torch.stack(losses))) / W}
        if telemetry and "telemetry" in info:
            metrics["telemetry"] = info["telemetry"]
        return params, opt_state, worker_m, metrics

    def init_worker_m(params):
        if not use_worker_momentum:
            return {}
        # the compute blocks' shapes (on a mesh from the specs, as
        # ``params`` holds storage blocks); whole leaves without one
        if params_shape is None:
            return tree_map(lambda p: torch.zeros((w_local,) + tuple(p.shape),
                                                  dtype=torch.float32, device=dev), params)
        return tree_map(lambda s, cpl: torch.zeros((w_local,) + cpl.local_shape(s.shape),
                                                   dtype=torch.float32, device=dev),
                        params_shape, compute)

    shardings = None
    if m is not None:
        rep = Placement(m, ())
        w_entry = batch_spec(m)[0]
        shardings = {
            "params": placements,
            # moments mirror the parameters; the step counter is replicated
            "opt_state": OptState(step=rep, m=placements,
                                  v=placements if optimizer == "adamw" else None),
            # each worker group's momentum rows, its compute blocks
            "worker_m": tree_map(lambda cpl: Placement(m, (w_entry,) + cpl.spec),
                                 compute) if use_worker_momentum else {},
            "compute": compute,
            "params_shape": params_shape,
            "replicated": rep,
        }
    state = {
        "worker_m": {"rows": w_local, "dtype": torch.float32} if use_worker_momentum else {},
        "workers": (first, first + w_local),
        "aggregator": aggregator,
        "shardings": shardings,
        "init_params": lambda generator: blocks(tfm.init_params(cfg, generator, device=dev)),
        "init_opt_state": opt_init,
        "init_worker_m": init_worker_m,
    }
    return step_fn, state


# ---------------------------------------------------------- serving blocks
def _serving_axis(cfg, m) -> Tuple[Any, Callable]:
    """The model axis a serving step computes along on mesh ``m`` (``None``
    with one model rank or no mesh), and a check that the ``params`` it is
    handed are this rank's compute blocks: each leaf of the shape the plan
    gives it (``sharding.compute_shardings``)."""
    ax = None if m is None else ModelAxis.of(cfg, m)
    if ax is None:
        return None, lambda params: None
    specs = tfm.params_shape(cfg)
    want = [pl.local_shape(s.shape) for s, pl in zip(
        tree_flatten(specs)[0], tree_flatten(compute_shardings(cfg, specs, m))[0])]

    def check(params):
        got = [tuple(x.shape) for x in tree_flatten(params)[0]]
        if got != want:
            raise ValueError(
                f"on a mesh whose model axis has {ax.size} ranks the serving steps take this "
                "rank's compute blocks of the parameters: cut them with "
                "sharding.compute_blocks(cfg, params, mesh)")

    return ax, check


# ------------------------------------------------------------ prefill step
def make_prefill_step(cfg, mesh=None, last_only: bool = True, device=None) -> Callable:
    """Serving prefill: ``prefill(params, batch) -> fp32 logits``.
    ``last_only`` (default) unembeds ONLY the final position, the next-token
    logits a server needs ([B, 1, V]); the full-sequence [B, S, V] fp32
    logits would dominate peak memory. ``batch["tokens"]`` ([B, S] ints;
    [B, K, S] for codebooks) and ``batch["prefix_embeds"]`` ([B, n_prefix,
    D], optional) are moved to ``device``, where the parameters must lie.
    It records no autograd state.

    On a mesh the B rows split over the worker axes (``batch_shardings``),
    each rank prefills its own and returns their logits; ``gather_batch``
    puts the ``[B, ...]`` logits together. ``params`` are whole on every
    rank where the mesh's model axis has one rank; where it has T > 1 they
    are this rank's compute blocks (``sharding.compute_blocks``; whole
    parameters raise a ``ValueError``): the forward runs on them along the
    model axis (a MoE layer on the rank's E/T experts, every rank routing
    all of its rows' tokens), and every rank of a model group returns the
    logits of all V of its rows."""
    dev = resolve_device(device)
    m = None if mesh is None else as_mesh(mesh)
    ax, check = _serving_axis(cfg, m)

    @torch.no_grad()
    def prefill(params, batch):
        check(params)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        prefix = batch.get("prefix_embeds")
        if prefix is not None:
            prefix = torch.as_tensor(prefix, device=dev)
        if m is not None:
            rows = Placement(m, (_rows_entry(m, tokens.shape[0]),))
            tokens = rows.local(tokens)
            prefix = None if prefix is None else rows.local(prefix)
        h, _ = tfm.forward_hidden(params, cfg, tokens, prefix_embeds=prefix, ax=ax)
        if last_only:
            h = h[:, -1:]
        return tfm.unembed(params, cfg, h, ax)

    return prefill


# ------------------------------------------------------------- decode step
def block_stats(logits: torch.Tensor) -> torch.Tensor:
    """A cache block's softmax statistics: per row and head the max of its
    fp32 logits ``[B, h, 1, l]`` and the sum of their exponentials after
    it, as ``[2 * B * h]`` (the maxes, then the sums). A block with no
    valid slot has max NEG_INF; its sum is scaled by exp(NEG_INF - max) =
    0 where the blocks meet (``merge_stats``)."""
    m_loc = torch.amax(logits, dim=-1, keepdim=True)
    l_loc = torch.sum(torch.exp(logits - m_loc), dim=-1, keepdim=True)
    return torch.cat([m_loc.reshape(-1), l_loc.reshape(-1)])


def merge_stats(stats: torch.Tensor, B: int, h: int):
    """The max and the sum of exponentials over all positions from every
    block's ``block_stats`` stacked in rank order (``[n, 2 B h]``): the max
    of the maxes, then each block's sum rescaled to it, summed in rank
    order. Each ``[B, h, 1, 1]``."""
    m_r = stats[:, :B * h].reshape(-1, B, h, 1, 1)
    l_r = stats[:, B * h:].reshape(-1, B, h, 1, 1)
    m_all = torch.amax(m_r, dim=0)
    return m_all, torch.sum(torch.exp(m_r - m_all) * l_r, dim=0)


def block_values(logits, v_e, m_all, l_all, dtype) -> torch.Tensor:
    """A block's share of the attention output ``[B, 1, h, dh]``, fp32: its
    probabilities ``exp(logits - m_all) / l_all`` rounded to ``dtype``, as
    ``attention.softmax_values`` rounds them, times its values, summed in
    fp32."""
    probs = (torch.exp(logits - m_all) / l_all).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v_e.float())


def _softmax_across(pl: Placement) -> Callable:
    """The ``attention.decode_attention`` combine for a KV cache block
    whose positions (dim 2 of the stacked cache) and heads (dim 3) ``pl``
    may split over ranks.

    Over the position ranks each rank's logits give, per head, a partial
    max and a partial sum of exponentials (``block_stats``); one gather
    brings every rank's two, and each rank finds the max, then the sum
    rescaled to it, in rank order (``merge_stats``). The probabilities are
    rounded to the cache dtype, as ``softmax_values`` rounds them, and each
    rank's values weighted by them are summed in fp32 (``block_values``);
    a second gather sums those in rank order (``combine.fp32_sums``) and
    rounds once, so every rank holds the same bits. The heads' outputs are
    then gathered over the head ranks. One device sums all positions'
    products in one fp32 accumulation and rounds once: the two agree but
    for the order of the fp32 sums, and of the probabilities' own fp32
    rounding before their cast (``tests/test_torch_tp_serving.py``)."""
    m = pl.mesh
    seq = Placement(m, (pl.spec[2],))  # a leading dim over the position ranks
    heads = Placement(m, (None, None, pl.spec[3]))

    def fp32_sums(logits, v_e, dtype):
        B, h = logits.shape[:2]
        m_all, l_all = merge_stats(seq.gather(block_stats(logits)[None]), B, h)
        part = block_values(logits, v_e, m_all, l_all, dtype)
        return torch.sum(seq.gather(part[None]), dim=0)

    def combine(logits, v_e, dtype):
        if seq.parts(0) == 1:
            return heads.gather(attn_mod.softmax_values(logits, v_e, dtype))
        return heads.gather(fp32_sums(logits, v_e, dtype).to(dtype))

    combine.fp32_sums = fp32_sums
    return combine


def make_serve_step(cfg, mesh, shape, device=None) -> Tuple[Callable, Any, Any]:
    """Returns ``(serve_fn, cache_spec, cache_placements)``:
    ``serve_fn(params, cache, token, position) -> (logits, cache)`` decodes
    one token for the ``shape.global_batch`` rows of a ``shape.seq_len``
    cache; ``cache_spec`` is the whole cache's ``TensorSpec`` tree and
    ``cache_placements`` its ``Placement`` tree (``cache_shardings``;
    ``sharding.local_zeros`` builds this rank's empty blocks).

    ``params`` are whole on every rank where the mesh's model axis has one
    rank, and this rank's compute blocks (``sharding.compute_blocks``;
    whole parameters raise a ``ValueError``) where it has T > 1: the
    embedding, the attention layers, MLPs, MoE experts and head the plan
    splits run on them along the model axis (``attention.decode_attention``'s
    ``ax``; a MoE layer routes the step's tokens whole on every rank), and
    every rank of a model group returns the logits of all V.
    ``cache`` is this rank's blocks; ``token`` the global ``[B]`` (``[B,
    K]``) tokens. Where the worker groups divide B the cache is
    batch-sharded and each rank decodes its own rows, returning their
    logits (``gather_batch``); else (batch 1, long context) the KV cache
    is sequence-sharded over ``data`` with the heads over ``model`` and
    every rank returns all B rows' logits, the attention crossing the
    ranks (``_softmax_across``). A cache dim the rules place elsewhere (an
    SSM state's channels, a head dim) is gathered for the step and cut
    again after it. Where the model axis splits the SSM heads, an SSM
    layer decodes on its compute blocks of the cache (its heads' state;
    the x channels of its heads and the whole B / C channels of the conv
    ring): the SSM caches whose storage block is another are gathered
    from it and cut to the compute block, then gathered from the compute
    blocks and cut to the storage block again, each way one all-gather
    over the model group for all of them (every layer's, ``gather_many``),
    once a step."""
    dev = resolve_device(device)
    m = as_mesh(mesh)
    ax, check = _serving_axis(cfg, m)
    attn_ax = ax if ax is not None and ax.attn else None
    B = shape.global_batch
    cache_spec = tfm.cache_shape(cfg, B, shape.seq_len)
    placements = cache_shardings(cache_spec, m, B)
    rows = Placement(m, (_rows_entry(m, B),))
    pl_at = dict(tree_flatten_with_path(placements)[0])

    def kv(path: str, ndim: int) -> bool:
        return path.split("/")[-1] in ("k", "v") and ndim == 5

    # the dims gathered for the step: all but batch and a KV cache's
    # positions and heads, which the step handles as they lie
    specs = tree_flatten_with_path(cache_spec)[0]
    gathered = {path: [d for d in pl_at[path].sharded_dims(len(s.shape))
                       if d not in ((1, 2, 3) if kv(path, len(s.shape)) else (1,))]
                for path, s in specs}
    # each attention layer's block of the ring (slots, kv heads) and combine
    combines, spans = {}, {}
    for path, s in specs:
        if kv(path, len(s.shape)) and path.endswith("/k"):
            i, pl = path.split("/")[0], pl_at[path]
            (l0, l1), (k0, k1) = pl.ranges(s.shape)[2:4]
            combines[i], spans[i] = _softmax_across(pl), ((l0, l1, s.shape[2]), (k0, k1))
    spread = any(pl_at[f"{i}/k"].parts(2) * pl_at[f"{i}/k"].parts(3) > 1 for i in spans)
    # the SSM caches a step exchanges: path -> compute placement (the
    # batch dim as the storage places it); a cache whose storage block is
    # its compute block (Jamba's state on its heads) decodes as it lies
    exchanged = {}
    if ax is not None and ax.ssm:
        conv = ssm_segments(cfg)["conv"]
        for path, s in specs:
            i, name = path.split("/")
            if cfg.pattern_[int(i)][0] != "ssm":
                continue
            spec = (None, None, None, conv) if name == "conv" else (None, None, "model", None,
                                                                     None)
            if [e for d, e in enumerate(pl_at[path].spec) if d != 1] == list(spec[:1] + spec[2:]):
                gathered[path] = []
            else:
                exchanged[path] = Placement(m, spec)

    def attend(i, p, x, layer_cache, position):
        return attn_mod.decode_attention(p, x, layer_cache, cfg, position, span=spans[str(i)],
                                         combine=combines[str(i)], ax=attn_ax)

    def exchange(tree, source, dims=None):
        """The exchanged SSM caches of ``tree`` gathered whole from the
        blocks that ``source`` (path -> placement) places, on ``dims``
        (path -> dims; all cut dims without it), by one all-gather."""
        leaves = dict(tree_flatten_with_path(tree)[0])
        paths = list(exchanged)
        return dict(zip(paths, gather_many([leaves[p] for p in paths],
                                           [source[p] for p in paths],
                                           [dims and dims[p] for p in paths])))

    @torch.no_grad()
    def serve(params, cache, token, position):
        check(params)
        token = rows.local(torch.as_tensor(token, device=dev))
        into = exchange(cache, pl_at, gathered)
        whole = tree_map_with_path(
            lambda path, x: exchanged[path].local(into[path]) if path in exchanged
            else pl_at[path].gather(x, dims=gathered[path]), cache)
        del into
        logits, new = tfm.decode_step(params, cfg, whole, token, position,
                                      attend=attend if spread else None, ax=ax)
        back = exchange(new, exchanged)
        new = tree_map_with_path(lambda path, x: pl_at[path].local(back.get(path, x),
                                                                   dims=gathered[path]), new)
        return logits, new

    return serve, cache_spec, placements
