"""Rank bodies for tests/test_torch_shard_engine.py.

``run_all`` runs in every process of a gloo group on the CPU
(``repro_torch.launch.mesh.spawn_ranks``). This module imports torch and
the port only, so the rank processes never import jax; the test modules
compute the JAX side and hand the ranks the same numpy inputs and the
reference's mixing matrices. ``run_telemetry`` serves
tests/test_torch_telemetry.py; ``run_train`` the worker-sharded train step;
``train_step_refusals`` tests/test_torch_train.py; ``fsdp_remat_step``
tests/test_torch_remat.py; ``tensor_parallel``
tests/test_torch_tensor_parallel.py; ``tp_serving``
tests/test_torch_tp_serving.py.
"""

import contextlib

import torch

from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import packing, shard_kernels
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.utils.tree import tree_flatten

#: shard_kernels functions the engine may route through, counted per sync
ROUTED = ("gram", "mix_apply", "cm_aggregate", "tm_aggregate", "coordinatewise_combine",
          "residual_norms", "cclip_fused_iter", "rfa_aggregate", "cclip_aggregate")


def _primitives(group, p):
    """Each sharded primitive and composition on this rank's column slice;
    column-sharded outputs are replicated back to the global shape."""
    xs = torch.tensor(p["xs"])
    n = xs.shape[1]
    local = shard_kernels.shard_cols(xs, group)
    coeffs, lam = torch.tensor(p["coeffs"]), torch.tensor(p["lam"])
    center = shard_kernels.shard_cols(torch.tensor(p["center"]), group)
    v0 = shard_kernels.shard_cols(torch.tensor(p["v0"]), group)
    full = lambda t: shard_kernels.unshard_cols(t, n, group)  # noqa: E731
    v_new, r2 = shard_kernels.cclip_fused_iter(local, v0, lam, group)
    return {
        "n_local": local.shape[1],
        "gram": shard_kernels.gram(local, group),
        "mix": full(shard_kernels.mix_apply(torch.tensor(p["mix"]), local, group)),
        "cm": full(shard_kernels.cm_aggregate(local, group)),
        "tm": full(shard_kernels.tm_aggregate(local, 2, group)),
        "cw": full(shard_kernels.coordinatewise_combine(
            local, group, lambda b: b.sum(0))),
        "norms_c": shard_kernels.residual_norms(local, coeffs, group=group),
        "norms_v": shard_kernels.residual_norms(local, center=center, group=group),
        "cclip_v": full(v_new),
        "cclip_r2": r2,
        "rfa": full(shard_kernels.rfa_aggregate(local, group)),
        "cclip": full(shard_kernels.cclip_aggregate(local, p["tau"], group)),
    }


@contextlib.contextmanager
def _counted():
    """Counts, in the dict it yields, the calls of each ``ROUTED`` function."""
    hits = {}
    originals = {name: getattr(shard_kernels, name) for name in ROUTED}

    def counting(name):
        def wrapper(*args, **kwargs):
            hits[name] = hits.get(name, 0) + 1
            return originals[name](*args, **kwargs)
        return wrapper

    try:
        for name in ROUTED:
            setattr(shard_kernels, name, counting(name))
        yield hits
    finally:
        for name, fn in originals.items():
            setattr(shard_kernels, name, fn)


def _routes(group, tree, specs):
    """Which shard_kernels functions each rule's sync calls, and how often."""
    out = {}
    for label, (agg, kwargs) in specs.items():
        ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
        with _counted() as hits:
            packing.packed_robust_sync(tree, ra, mesh=group)
        out[label] = hits
    return out


def run_all(rank, group, device, payload):
    tree = {k: torch.tensor(v, device=device) for k, v in payload["tree"].items()}
    syncs = {}
    for label, (agg, kwargs, mixing, mix) in payload["syncs"].items():
        ra = RobustAggregator.from_spec(agg, mixing=mixing, s=2, **kwargs)
        out, _ = robust_gradient_sync(tree, ra, mix=torch.tensor(mix, device=device),
                                      mesh=group, engine="packed")
        syncs[label] = out
    return {
        "rank": rank,
        "world_size": torch.distributed.get_world_size(group),
        "primitives": _primitives(group, payload["primitives"]),
        "syncs": syncs,
        "routes": _routes(group, tree, payload["routes"]),
    }


def run_telemetry(rank, group, device, payload):
    """Each rule's sync over the group with telemetry off and then on: both
    results, the metrics, and the shard_kernels calls of each."""
    tree = {k: torch.tensor(v, device=device) for k, v in payload["tree"].items()}
    out = {}
    for label, (agg, kwargs, mix) in payload["syncs"].items():
        ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
        runs = {}
        for telemetry in (False, True):
            with _counted() as hits:
                res, info = robust_gradient_sync(tree, ra, mix=torch.tensor(mix, device=device),
                                                 mesh=group, telemetry=telemetry)
            runs[telemetry] = dict(result=res, routes=hits, info=info)
        out[label] = {"off": runs[False], "on": runs[True]}
    return out


def run_train(rank, group, device, payload):
    """The worker-sharded ingress on a random stack, then ``make_train_step``
    over the group (this rank's workers only) for each rule's steps; the
    parameters, losses and shard_kernels calls of each."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step

    stack = torch.tensor(payload["stack"], device=device)
    R, W = torch.distributed.get_world_size(group), stack.shape[0]
    rows = stack[rank * (W // R):(rank + 1) * (W // R)]
    out = {"ingress": packing.reshard_in(rows, group, worker_sharded=True),
           "shard_cols": shard_kernels.shard_cols(stack, group), "runs": {}}
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **payload["cfg"])
    batch = {k: torch.tensor(v, device=device) for k, v in payload["batch"].items()}
    for label, (agg, mixes) in payload["runs"].items():
        byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9)
        step_fn, state = make_train_step(cfg, byz, mesh=group, lr=payload["lr"],
                                         n_workers=W, device=device)
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
        losses = []
        with _counted() as hits:
            for mix in mixes:
                params, opt_state, worker_m, metrics = step_fn(
                    params, opt_state, worker_m, torch.tensor(mix, device=device), batch)
                losses.append(metrics["loss"])
        out["runs"][label] = dict(params=params, losses=losses, routes=hits,
                                  workers=state["workers"])
    return out


def train_step_refusals(rank, group, device):
    """``make_train_step`` over a group: an fsdp config builds (its embed's
    placement), workers that do not split over the ranks raise (the
    message)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step

    cfg = smoke_config("tinyllama-1.1b")
    out = {}
    for label, c, n in (("fsdp", dataclasses.replace(cfg, fsdp=True), 2),
                        ("uneven", cfg, 3)):
        try:
            _, state = make_train_step(c, ByzConfig(), mesh=group, n_workers=n, device=device)
            out[label] = state["shardings"]["params"]["embed"].spec
        except (NotImplementedError, ValueError) as e:
            out[label] = f"{type(e).__name__}: {e}"
    return out


def fsdp_remat_step(rank, group, device, payload):
    """One RFA step of ``payload["arch"]`` at smoke width, fsdp on the
    (data=R, model=1) mesh, with ``remat`` "none" and then "full" from the
    same state: for each, the gathered parameters and optimizer momentum,
    the step counter and the loss (tests/test_torch_remat.py)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.tree import tree_map

    mesh = make_host_mesh(group, data=torch.distributed.get_world_size(group), model=1)
    base = dataclasses.replace(smoke_config(payload["arch"]), fsdp=True, momentum_mode="server")
    W = payload["W"]
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab_size, (W, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    remats, runs = ("none", "full"), []
    for remat in remats:
        cfg = dataclasses.replace(base, remat=remat)
        step_fn, state = make_train_step(cfg, ByzConfig(aggregator="rfa", mixing="bucketing",
                                                        s=2), mesh=mesh, lr=0.05, n_workers=W,
                                         device=device)
        sh = state["shardings"]
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state = state["init_opt_state"](params)
        mix = state["aggregator"].mixing_matrix(W, torch.Generator().manual_seed(2),
                                                device=device)
        params, opt_state, _, metrics = step_fn(params, opt_state, {}, mix, batch)
        gather = lambda t: tree_map(lambda b, pl: pl.gather(b), t, sh["params"])  # noqa: E731
        runs.append(tree_flatten((gather(params), gather(opt_state.m), opt_state.step,
                                  metrics["loss"]))[0])
    return {"fsdp": base.fsdp, "remat": remats, "runs": runs}


def fail_on_rank_one(rank, group, device):
    """Rank 1 raises while rank 0 hangs, as a rank stuck in a collective
    would."""
    if rank == 1:
        raise ValueError("rank one fails")
    import time

    time.sleep(600)


# --------------------------------------------------------- sharding on a mesh
def _counting_all_to_all():
    """A stand-in for ``dist.all_to_all_single`` that records each call's
    received elements, and the list it records into."""
    import torch.distributed as dist

    calls, original = [], dist.all_to_all_single

    def counted(output, input, output_split_sizes=None, input_split_sizes=None, **kw):
        calls.append(int(output.numel()))
        return original(output, input, output_split_sizes, input_split_sizes, **kw)

    return calls, original, counted


def _egress(mesh, tree, mixes):
    """Each rule's packed sync on the mesh with the replicated and the
    param-sharded egress; the per-leaf engine's kernel route on the mesh."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.utils.tree import TensorSpec, tree_map

    specs = tree_map(lambda x: TensorSpec(tuple(x.shape[1:]), x.dtype), tree)
    placements = param_shardings(specs, mesh, fsdp=True)
    out = {"specs": tree_map(lambda pl: pl.spec, placements), "rules": {}}
    for label, (agg, kwargs, mix) in mixes.items():
        ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
        mix = torch.tensor(mix)
        rep, _ = robust_gradient_sync(tree, ra, mix=mix, mesh=mesh)
        calls, original, counted = _counting_all_to_all()
        unshard = shard_kernels.unshard_cols
        hits = []
        shard_kernels.unshard_cols = lambda *a, **k: hits.append(1) or unshard(*a, **k)
        dist.all_to_all_single = counted
        try:
            par, info = robust_gradient_sync(tree, ra, mix=mix, mesh=mesh,
                                             out_shardings=placements, telemetry=True)
        finally:
            dist.all_to_all_single = original
            shard_kernels.unshard_cols = unshard
        leaf, _ = robust_gradient_sync(tree, ra, mix=mix, mesh=mesh, engine="per_leaf",
                                       use_kernels=True)
        leaf_par, _ = robust_gradient_sync(tree, ra, mix=mix, mesh=mesh, engine="per_leaf",
                                           use_kernels=True, out_shardings=placements)
        out["rules"][label] = dict(
            replicated=rep, sharded=par,
            cut=tree_map(lambda g, pl: pl.local(g), rep, placements),
            egress_recv=calls, unshard_calls=len(hits),
            block_elems=sum(int(torch.tensor(pl.local_shape(s.shape)).prod())
                            for pl, s in zip(tree_flatten(placements)[0],
                                             tree_flatten(specs)[0])),
            egress_bytes=int(info["telemetry"]["sync_egress_bytes"]),
            per_leaf=leaf, per_leaf_cut=leaf_par)
    return out


def _train(mesh, p, rank):
    """The fsdp config's steps on the mesh, and the same config with fsdp
    off (the replicated egress) on the same mesh: gathered parameters and
    momenta, losses, and the placements."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.utils.tree import tree_map

    base = dataclasses.replace(smoke_config(p["arch"]), **p["cfg"])
    batch = {k: torch.tensor(v) for k, v in p["batch"].items()}
    out = {}
    for fsdp in (True, False):
        cfg = dataclasses.replace(base, fsdp=fsdp)
        for agg, mixes in p["runs"].items():
            byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2)
            step_fn, state = make_train_step(cfg, byz, mesh=mesh, lr=p["lr"],
                                             n_workers=p["W"], device="cpu")
            sh = state["shardings"]
            params = state["init_params"](torch.Generator().manual_seed(0))
            opt_state = state["init_opt_state"](params)
            worker_m = state["init_worker_m"](params)
            losses = []
            for mix in mixes:
                params, opt_state, worker_m, metrics = step_fn(
                    params, opt_state, worker_m, torch.tensor(mix), batch)
                losses.append(metrics["loss"])
            gather = lambda t: tree_map(lambda b, pl: pl.gather(b), t, sh["params"])  # noqa: E731
            run = dict(params=gather(params), m=gather(opt_state.m), losses=losses,
                       local_elems=sum(int(x.numel()) for x in tree_flatten(params)[0]),
                       specs=tree_map(lambda pl: pl.spec, sh["params"]))
            if fsdp and agg == "rfa":
                tree = {"params": params, "opt_state": opt_state, "worker_m": worker_m}
                shardings = {"params": sh["params"], "opt_state": sh["opt_state"],
                             "worker_m": sh["worker_m"]}
                save_checkpoint(p["ckpt_dir"], 3, tree, shardings=shardings)
                restored = _restore_blocks(p["ckpt_dir"], tree, shardings)
                run["restored"] = [restored["params"], restored["opt_state"].m,
                                   restored["opt_state"].step]
                run["blocks"] = [params, opt_state.m, opt_state.step]
            out[(fsdp, agg)] = run
    return out


def _restore_blocks(directory, tree, shardings):
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.utils.tree import tree_map_with_path

    like = tree_map_with_path(lambda _, x: torch.zeros_like(x), tree)
    return restore_checkpoint(directory, like, shardings=shardings)


def _serve(mesh, p):
    """The sharded prefill, and greedy decode through ``make_serve_step``
    with a batch-sharded and with a sequence-sharded cache, on this rank's
    compute blocks of the parameters (whole where the model axis has one
    rank)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import compute_blocks, local_zeros
    from repro_torch.distributed.steps import gather_batch, make_prefill_step, make_serve_step
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(smoke_config(p["arch"]), **p["cfg"])
    params = compute_blocks(cfg, params_from_jax(p["params"], "cpu"), mesh)
    prompt = torch.tensor(p["prompt"])
    out = {}
    prefill = make_prefill_step(cfg, mesh, device="cpu")
    local = prefill(params, {"tokens": prompt})
    out["prefill_local"] = local
    out["prefill"] = gather_batch(local, mesh, prompt.shape[0])
    for label, B in (("batch", prompt.shape[0]), ("sequence", 1)):
        shape = InputShape("test", seq_len=p["cache_len"], global_batch=B, kind="decode")
        serve, spec, placements = make_serve_step(cfg, mesh, shape, device="cpu")
        cache = local_zeros(spec, placements, "cpu")
        tokens = prompt[:B]
        logits_seq, chosen = [], []
        for pos in range(tokens.shape[1] + p["new_tokens"]):
            tok = tokens[:, pos] if pos < tokens.shape[1] else chosen[-1]
            logits, cache = serve(params, cache, tok, pos)
            logits = gather_batch(logits, mesh, B) if label == "batch" else logits
            logits_seq.append(logits)
            chosen.append(torch.argmax(logits, dim=-1))
        out[label] = dict(logits=torch.stack(logits_seq), tokens=torch.stack(chosen),
                          specs={k: v["k"].spec for k, v in placements.items()},
                          cache_elems=sum(int(x.numel()) for x in tree_flatten(cache)[0]))
    # the sequence-sharded cache in bf16, fed the prompt and then the fp32
    # run's tokens
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    shape = InputShape("test", seq_len=p["cache_len"], global_batch=1, kind="decode")
    serve, spec, placements = make_serve_step(cfg16, mesh, shape, device="cpu")
    cache = local_zeros(spec, placements, "cpu")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    feed = torch.cat([prompt[:1], out["sequence"]["tokens"][prompt.shape[1] - 1:-1].T], dim=1)
    logits_seq = []
    for pos in range(feed.shape[1]):
        logits, cache = serve(p16, cache, feed[:, pos], pos)
        logits_seq.append(logits.float())
    out["sequence_bf16"] = dict(logits=torch.stack(logits_seq), feed=feed)
    return out


def _qwen_serve(mesh, p):
    """``tests/test_steps.py::test_serve_step_executes`` on the mesh: one
    decode step of smoke qwen2.5-14b (qkv bias) from an empty cache."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import compute_blocks, local_zeros
    from repro_torch.distributed.steps import gather_batch, make_serve_step

    cfg = smoke_config("qwen2.5-14b")
    shape = InputShape("test_decode", seq_len=64, global_batch=2, kind="decode")
    serve, spec, placements = make_serve_step(cfg, mesh, shape, device="cpu")
    logits, _ = serve(compute_blocks(cfg, params_from_jax(p, "cpu"), mesh),
                      local_zeros(spec, placements, "cpu"), torch.zeros(2, dtype=torch.long), 0)
    return {"local": tuple(logits.shape), "logits": gather_batch(logits, mesh, 2)}


def _three_axes(group):
    """A ("pod", "data", "model") mesh of (2, 2, 1): coordinates, worker
    axes, and a dim placed on ("pod", "data") gathered back; the worker
    rows ``constrain_worker_tree`` cuts."""
    from repro_torch.distributed.sharding import Placement, constrain_worker_tree
    from repro_torch.launch.mesh import make_host_mesh, n_workers, worker_axes

    mesh = make_host_mesh(group, data=2, model=1, pod=2)
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    pl = Placement(mesh, (("pod", "data"), None))
    rows = constrain_worker_tree({"w": full}, {"w": Placement(mesh, (None,))}, mesh)["w"]
    return {"coords": mesh.coords, "worker_axes": worker_axes(mesh),
            "n_workers": n_workers(mesh), "block": pl.local(full),
            "gathered": pl.gather(pl.local(full)), "rows": rows}


#: the cross-rank softmax's inputs: 1 row, H heads, L positions, dh
COMBINE_SHAPE = (8, 256, 64)


def combine_inputs(dtype):
    """Masked fp32 logits ``[1, H, 1, L]`` (the last 40 slots empty) and
    values ``[1, L, H, dh]`` in ``dtype``, from a fixed seed."""
    H, L, dh = COMBINE_SHAPE
    gen = torch.Generator().manual_seed(9)
    logits = 3.0 * torch.randn((1, H, 1, L), generator=gen)
    logits[..., L - 40:] = -1e30
    values = torch.randn((1, L, H, dh), generator=gen).to(dtype)
    return logits, values


def _combine(mesh):
    """``steps._softmax_across`` on this rank's positions (over data) and
    heads (over model) of ``combine_inputs``, in fp32 and bf16."""
    from repro_torch.distributed.sharding import Placement
    from repro_torch.distributed.steps import _softmax_across

    H, L, dh = COMBINE_SHAPE
    pl = Placement(mesh, (None, None, "data", "model", None))
    (l0, l1), (h0, h1) = pl.ranges((1, 1, L, H, dh))[2:4]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits, values = combine_inputs(dtype)
        out[str(dtype)] = _softmax_across(pl)(logits[:, h0:h1, :, l0:l1],
                                              values[:, l0:l1, h0:h1], dtype).float()
    return out


def run_mesh(rank, group, device, p):
    """Everything the mesh tests hold on one ``make_host_mesh`` of the
    group: the param-sharded egress, the per-leaf engine on the mesh, the
    fsdp train step and its checkpoint, the sharded prefill and decode;
    and a three-axis mesh of the same group."""
    from repro_torch.launch.mesh import make_host_mesh, n_workers, worker_axes

    mesh = make_host_mesh(group, *p["mesh"])
    tree = {k: torch.tensor(v, device=device) for k, v in p["tree"].items()}
    return {"coords": mesh.coords, "worker_axes": worker_axes(mesh),
            "n_workers": n_workers(mesh),
            "egress": _egress(mesh, tree, p["mixes"]),
            "train": _train(mesh, p["train"], rank),
            "serve": _serve(mesh, p["serve"]),
            "combine": _combine(mesh),
            "qwen": _qwen_serve(mesh, p["qwen_params"]),
            "three_axes": _three_axes(group)}


# ------------------------------------------------------ collective records
def record_each_collective(rank, group, device):
    """Every collective ``launch.collectives.record_collectives`` wraps, once,
    on 2 ranks: what each rank recorded."""
    import torch.distributed as dist

    from repro_torch.launch.collectives import record_collectives

    x = torch.arange(6, dtype=torch.float32) + rank
    original = dist.all_reduce
    with record_collectives() as calls:
        dist.all_reduce(x.clone(), group=group)
        dist.all_gather([torch.empty(6), torch.empty(6)], x, group=group)
        dist.all_gather_into_tensor(torch.empty(12), x, group=group)
        dist.all_to_all_single(torch.empty(6), x, group=group)
        dist.broadcast(x.clone(), src=0, group=group)
        dist.reduce_scatter_tensor(torch.empty(3), x, group=group)
        if rank == 0:
            dist.send(x, dst=1, group=group)
        else:
            dist.recv(torch.empty(6), src=0, group=group)
        dist.barrier(group=group)
    assert dist.all_reduce is original  # the originals are back after the block
    return [(c.kind, c.fn, c.sent, c.received, c.buffers) for c in calls]


def per_leaf_16bit(rank, group, device, payload):
    """The per-leaf engine's kernel route over ``group`` on a tree of 16-bit
    leaves (``payload``: the fp32 values, the dtype's name, the mixing
    matrices and keyword arguments by rule), and the dtypes of the column
    slices the route hands the kernels (``shard_kernels.mix_apply`` spied)."""
    dtype = getattr(torch, payload["dtype"])
    tree = {k: torch.tensor(v).to(dtype) for k, v in payload["tree"].items()}
    seen = []
    real = shard_kernels.mix_apply

    def spy(mix, local, group_):
        seen.append(str(local.dtype))
        return real(mix, local, group_)

    out = {}
    shard_kernels.mix_apply = spy
    try:
        for agg, mix in payload["mixes"].items():
            ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2,
                                            **payload["rules"][agg])
            got, _ = robust_gradient_sync(tree, ra, mix=torch.tensor(mix), mesh=group,
                                          engine="per_leaf", use_kernels=True)
            out[agg] = {k: v.float() for k, v in got.items()}
    finally:
        shard_kernels.mix_apply = real
    return {"out": out, "seen": seen}


# ------------------------------------------------- compute along the model axis
def _tp_case(mesh, case):
    """One case of ``tensor_parallel``: the loss and every gradient of
    ``loss_fn`` on this rank's compute blocks, the gradients gathered
    whole; the collectives the forward and backward made (kind, function,
    bytes received); the embedded stream; the blocks' shapes."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import compute_shardings
    from repro_torch.launch.collectives import record_collectives
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import ModelAxis, model_split
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map, tree_unflatten

    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["cfg"])
    compute = compute_shardings(cfg, tfm.params_shape(cfg), mesh)
    ax = ModelAxis.of(cfg, mesh)
    own = tree_map(lambda x, pl: pl.local(x), params_from_jax(case["params"], "cpu"), compute)
    leaves, treedef = tree_flatten(own)
    live = [p.detach().requires_grad_() for p in leaves]
    p_live = tree_unflatten(treedef, live)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    with moe.recorded_routes() as routes, record_collectives() as calls:
        loss, aux = tfm.loss_fn(p_live, cfg, batch, ax=ax)
        grads = torch.autograd.grad(loss, live)
    placements = tree_flatten(compute)[0]
    with torch.no_grad():
        h = tfm.embed_tokens(p_live, cfg, batch["tokens"], ax)
    return {"loss": loss.detach(), "grads": [pl.gather(g) for g, pl in zip(grads, placements)],
            "h": h, "local": [tuple(g.shape) for g in grads], "routes": routes,
            "drop": aux.get("moe_drop_frac"),
            "calls": [(c.kind, c.fn, c.received) for c in calls],
            "attn_blocks": {path: x for path, x in tree_flatten_with_path(own)[0]
                            if path.split("/")[-1] in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")},
            "split": None if ax is None else {k: getattr(ax, k)
                                              for k in model_split(cfg, ax.size)}}


def _tp_ingress(mesh, arch, fields):
    """The block ingress of a random global stack over ``arch``'s one-layer
    smoke compute plan with ``fields`` (each rank its workers' rows, its
    compute blocks; Mamba2's SSM leaves segmented, replicated attention
    blocks where the model axis's size does not divide the heads) against
    ``shard_cols`` of the packed global stack; and the egress of the
    ingress's first row to the compute blocks against that row's leaves
    cut by the plan."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import Placement, compute_shardings
    from repro_torch.launch.mesh import n_workers
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(smoke_config(arch), n_layers=1, **fields)
    specs = tfm.params_shape(cfg)
    compute = compute_shardings(cfg, specs, mesh)
    G = n_workers(mesh)
    w = 2
    g = torch.Generator().manual_seed(3)
    stack = tree_map(lambda s: torch.randn((G * w,) + tuple(s.shape), generator=g), specs)
    me = mesh.coords["data"]
    mine = tree_map(lambda x, pl: Placement(mesh, (None,) + pl.spec).local(
        x[me * w:(me + 1) * w]), stack, compute)
    packer = packing.packer_for(mine, compute)
    blocks = packing.pack_from_shardings(packer, mine, compute, mesh)
    row = tree_map(lambda x, pl: pl.local(x[0]), stack, compute)
    return {"blocks": blocks,
            "rows_to_cols": shard_kernels.shard_cols(packing.packer_for(stack).pack(stack),
                                                      mesh.group),
            "egress": tree_flatten(packing.unpack_to_shardings(packer, blocks[0], compute))[0],
            "row": tree_flatten(row)[0],
            "specs": [pl.spec for pl in tree_flatten(compute)[0]]}


def _tp_replicated(mesh):
    """A seeded ``[3, 8, 6]`` tensor under the replicated-block entry
    ``("model", 2)`` on its middle dim (two blocks, each held by T / 2
    ranks): this rank's block (``local``), the whole ``gather`` rebuilds
    from every rank's block, and ``gather_many``'s of it beside a leaf cut
    plainly on the model axis."""
    from repro_torch.distributed.sharding import Placement, gather_many

    full = torch.randn(3, 8, 6, generator=torch.Generator().manual_seed(5))
    pl = Placement(mesh, (None, ("model", 2), None))
    plain = Placement(mesh, (None, None, "model"))
    other = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(6))
    block = pl.local(full)
    both = gather_many([block, plain.local(other)], [pl, plain], [None, None])
    return {"full": full, "block": block, "gather": pl.gather(block), "many": both,
            "other": other, "index": mesh.coords["model"]}


def project_heads_inputs():
    """A seeded fp32 attention output ``x`` [2, 8, 24] (6 heads of 4), the
    rows of wo ``w`` [24, 16] and the output's weights ``g`` [2, 8, 16]
    (``test_torch_tensor_parallel.py``)."""
    gen = torch.Generator().manual_seed(33)
    return (torch.randn(2, 8, 24, generator=gen), torch.randn(24, 16, generator=gen) / 5,
            torch.randn(2, 8, 16, generator=gen))


def _tp_project_heads(mesh):
    """``ModelAxis.project_heads`` over 2 head blocks of 3 heads, each held
    by T / 2 ranks: each rank's output from its block's columns of ``x``
    and rows of ``w``, its gradients of ``sum(out * g)`` by those, and the
    collectives the forward and backward made."""
    import dataclasses

    from repro_torch.launch.collectives import record_collectives
    from repro_torch.models.parallel import ModelAxis

    T = mesh.shape["model"]
    ax = ModelAxis(mesh.axis_group("model"), mesh.coords["model"], T, *([True] * 6), t=2)
    dense = dataclasses.replace(ax, moe=False, moe_shared=False)
    x, w, g = project_heads_inputs()
    b = x.shape[-1] // 2
    cols = slice(ax.head_block * b, (ax.head_block + 1) * b)
    xs, ws = x[..., cols].clone().requires_grad_(), w[cols].clone().requires_grad_()
    with record_collectives() as calls:
        out = dense.project_heads(xs, ws)
        grads = torch.autograd.grad((out * g).sum(), [xs, ws])
    return {"out": out.detach(), "grads": list(grads), "replica": ax.replica,
            "block": ax.head_block, "calls": [(c.kind, c.fn, c.received) for c in calls]}


def gated_norm_inputs():
    """A seeded fp32 gated stream ``[2, 16, 512]``, norm scale ``[512]``,
    out_proj ``[512, 256]`` and output weights ``[2, 16, 256]`` at smoke
    Mamba2's d_inner and width (``test_torch_tensor_parallel.py``)."""
    gen = torch.Generator().manual_seed(31)
    return {"gated": torch.randn(2, 16, 512, generator=gen),
            "norm_scale": 1.0 + 0.1 * torch.randn(512, generator=gen),
            "out_proj": torch.randn(512, 256, generator=gen) / 512 ** 0.5,
            "r": torch.randn(2, 16, 256, generator=gen)}


def _tp_gated_norm(mesh):
    """The SSM's gated RMSNorm and out projection on this rank's d_inner / T
    columns (``ssm._gated_out`` with smoke Mamba2's axis): the output, and
    the gradients of ``sum(out * r)`` by the rank's columns of the stream,
    its scale and its rows of out_proj."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import ssm
    from repro_torch.models.parallel import ModelAxis

    cfg = smoke_config("mamba2-130m")
    ax = ModelAxis.of(cfg, mesh)
    x = gated_norm_inputs()
    b = cfg.d_inner // ax.size
    cols = slice(ax.index * b, (ax.index + 1) * b)
    g = x["gated"][..., cols].clone().requires_grad_()
    p = {"norm_scale": x["norm_scale"][cols].clone().requires_grad_(),
         "out_proj": x["out_proj"][cols].clone().requires_grad_()}
    out = ssm._gated_out(p, g, cfg, ax)
    grads = torch.autograd.grad((out * x["r"]).sum(), [g, p["norm_scale"], p["out_proj"]])
    return {"out": out.detach(), "grads": [t for t in grads], "index": ax.index}


def _tp_steps(mesh, p):
    """One RFA step of each momentum mode (gemma at smoke width), and one of
    each MoE config of ``p["moe"]`` (label -> arch, config fields), on the
    mesh: the gathered parameters and loss, and the rows the sync was
    handed and the worker momenta, beside this rank's compute blocks."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed import steps
    from repro_torch.utils.tree import tree_map

    out = {}
    sync = steps.robust_gradient_sync
    runs = [(mode, "gemma-7b", {"n_layers": 1, "momentum_mode": mode})
            for mode in ("worker", "server")]
    runs += [(label, arch, fields) for label, (arch, fields) in p["moe"].items()]
    for mode, arch, fields in runs:
        cfg = dataclasses.replace(smoke_config(arch), **fields)
        step_fn, state = steps.make_train_step(
            cfg, ByzConfig(aggregator="rfa", mixing="bucketing", s=2, worker_momentum=0.9),
            mesh=mesh, lr=0.05, n_workers=p["W"], device="cpu")
        sh = state["shardings"]
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
        seen = {}

        def spy(messages, *a, **kw):
            seen["rows"] = [tuple(x.shape) for x in tree_flatten(messages)[0]]
            seen["in_shardings"] = kw.get("in_shardings") is not None
            return sync(messages, *a, **kw)

        steps.robust_gradient_sync = spy
        try:
            params, opt_state, worker_m, metrics = step_fn(
                params, opt_state, worker_m, torch.tensor(p["mix"]),
                {k: torch.tensor(v) for k, v in p["batch"].items()})
        finally:
            steps.robust_gradient_sync = sync
        out[mode] = dict(
            params=tree_map(lambda b, pl: pl.gather(b), params, sh["params"]),
            loss=metrics["loss"], rows=seen["rows"], in_shardings=seen["in_shardings"],
            worker_m=[tuple(x.shape) for x in tree_flatten(worker_m)[0]],
            worker_m_specs=[pl.spec for pl in tree_flatten(sh["worker_m"])[0]],
            compute=[pl.local_shape(s.shape) for pl, s in zip(
                tree_flatten(sh["compute"])[0], tree_flatten(sh["params_shape"])[0])],
            compute_specs=[pl.spec for pl in tree_flatten(sh["compute"])[0]],
            w_local=state["workers"][1] - state["workers"][0])
    return out


def _tp_one_model_rank(group, p):
    """qwen2.5-14b's smoke fsdp step (server momentum, RFA) on the (4, 1)
    mesh and on the bare group (the mesh ("data",)): parameters, optimizer
    state, the collectives each made (kind, function, bytes received) and
    which ingress ran."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.collectives import record_collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.tree import tree_map

    cfg = smoke_config("qwen2.5-14b")
    out = {}
    for label, mesh in (("4x1", make_host_mesh(group, data=4, model=1)), ("bare", group)):
        step_fn, state = make_train_step(cfg, ByzConfig(aggregator="rfa", mixing="bucketing",
                                                        s=2), mesh=mesh, lr=0.05,
                                         n_workers=p["W"], device="cpu")
        sh = state["shardings"]
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state = state["init_opt_state"](params)
        hits = {"rows_to_cols": 0, "pack_from_shardings": 0}
        originals = {"rows_to_cols": shard_kernels.rows_to_cols,
                     "pack_from_shardings": packing.pack_from_shardings}

        def counting(name):
            def call(*a, **kw):
                hits[name] += 1
                return originals[name](*a, **kw)
            return call

        shard_kernels.rows_to_cols = counting("rows_to_cols")
        packing.pack_from_shardings = counting("pack_from_shardings")
        try:
            with record_collectives() as calls:
                params, opt_state, _, metrics = step_fn(
                    params, opt_state, {}, torch.tensor(p["mix"]),
                    {k: torch.tensor(v) for k, v in p["qwen_batch"].items()})
        finally:
            shard_kernels.rows_to_cols = originals["rows_to_cols"]
            packing.pack_from_shardings = originals["pack_from_shardings"]
        gather = lambda t: tree_map(lambda b, pl: pl.gather(b), t, sh["params"])  # noqa: E731
        out[label] = dict(params=gather(params), m=gather(opt_state.m), step=opt_state.step,
                          loss=metrics["loss"], hits=hits,
                          calls=[(c.kind, c.fn, c.received) for c in calls],
                          compute_specs=[pl.spec for pl in tree_flatten(sh["compute"])[0]],
                          params_specs=[pl.spec for pl in tree_flatten(sh["params"])[0]])
    return out


def tensor_parallel(rank, group, device, p):
    """Everything tests/test_torch_tensor_parallel.py holds, in one group:
    on each (data, model) mesh of ``p["meshes"]`` each case's loss and
    gradients on compute blocks, the block ingress of each arch of
    ``p["ingress"]``, the SSM's gated norm, the train steps; and the (4, 1)
    mesh of the same group against the bare group; the replicated-block
    placement and the attention head blocks' ``project_heads``."""
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    for shape in p["meshes"]:
        mesh = make_host_mesh(group, *shape)
        out[tuple(shape)] = {
            "coords": mesh.coords,
            "cases": {label: _tp_case(mesh, case) for label, case in p["cases"].items()},
            "ingress": {arch: _tp_ingress(mesh, arch, fields)
                        for arch, fields in p["ingress"].items()},
            "replicated": _tp_replicated(mesh), "project_heads": _tp_project_heads(mesh),
            "gated_norm": _tp_gated_norm(mesh), "steps": _tp_steps(mesh, p["steps"])}
    out["one_model_rank"] = _tp_one_model_rank(group, p["steps"])
    return out


# ------------------------------------------------------- serving along the model axis
def _tps_case(mesh, case, p):
    """One case of ``tp_serving``: this rank's compute blocks of the case's
    parameters, the prefill's last-position logits and a greedy decode
    through ``make_serve_step`` with a batch-sharded cache of all rows and,
    where the mesh has more than one worker group, a one-row cache (on
    (1, T) one row is batch-sharded too); the kinds of the collectives
    the last decode step made."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import compute_blocks, local_zeros
    from repro_torch.distributed.steps import gather_batch, make_prefill_step, make_serve_step
    from repro_torch.launch.collectives import record_collectives

    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["cfg"])
    whole = params_from_jax(case["params"], "cpu")
    params = compute_blocks(cfg, whole, mesh)
    leaves = tree_flatten(params)[0]
    prompt = torch.tensor(case["prompt"])
    B = prompt.shape[0]
    batch = {"tokens": prompt}
    if "prefix" in case:
        batch["prefix_embeds"] = torch.tensor(case["prefix"])
    out = {"shapes": [tuple(x.shape) for x in leaves],
           "bytes": sum(x.numel() * x.element_size() for x in leaves),
           "storage": sum(x.untyped_storage().nbytes() for x in leaves)}
    out["prefill"] = gather_batch(make_prefill_step(cfg, mesh, device="cpu")(params, batch),
                                  mesh, B)
    runs = [("batch", B)] + ([("single", 1)] if mesh.shape["data"] > 1 else [])
    for label, rows in runs:
        shape = InputShape("test", seq_len=p["cache_len"], global_batch=rows, kind="decode")
        serve, spec, placements = make_serve_step(cfg, mesh, shape, device="cpu")
        cache = local_zeros(spec, placements, "cpu")
        tokens = prompt[:rows]
        S = tokens.shape[-1]
        logits_seq, chosen = [], []
        for pos in range(S + p["new_tokens"]):
            tok = tokens[..., pos] if pos < S else chosen[-1]
            with record_collectives() as calls:
                logits, cache = serve(params, cache, tok, pos)
            logits = gather_batch(logits, mesh, rows)
            logits_seq.append(logits)
            chosen.append(torch.argmax(logits, dim=-1))
        first = next(iter(placements.values()))
        out[label] = dict(logits=torch.stack(logits_seq), tokens=torch.stack(chosen),
                          spec=next(iter(first.values())).spec,
                          step_calls=[c.kind for c in calls])
    return out


def _tps_whole_raises(mesh, case):
    """Whole parameters handed to either serving step on a mesh whose model
    axis has T > 1 ranks: the ``ValueError``s' messages, and the
    collectives the two calls made."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import local_zeros
    from repro_torch.distributed.steps import make_prefill_step, make_serve_step
    from repro_torch.launch.collectives import record_collectives

    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["cfg"])
    whole = params_from_jax(case["params"], "cpu")
    prompt = torch.tensor(case["prompt"])
    prefill = make_prefill_step(cfg, mesh, device="cpu")
    serve, spec, placements = make_serve_step(
        cfg, mesh, InputShape("test", 16, prompt.shape[0], "decode"), device="cpu")
    cache = local_zeros(spec, placements, "cpu")
    out = []
    with record_collectives() as calls:
        try:
            prefill(whole, {"tokens": prompt})
        except ValueError as e:
            out.append(str(e))
        try:
            serve(whole, cache, prompt[:, 0], 0)
        except ValueError as e:
            out.append(str(e))
    return {"messages": out, "calls": len(calls)}


def _tps_one_model_rank(group, case, p):
    """On the (4, 1) mesh of the group the serving steps take whole
    parameters and run today's route: the prefill's and each decode step's
    logits beside the same rows through ``forward_hidden`` / ``unembed``
    and ``decode_step`` called directly, and the collectives each made."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import Placement, local_zeros
    from repro_torch.distributed.steps import make_prefill_step, make_serve_step
    from repro_torch.launch.collectives import record_collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import ModelAxis

    mesh = make_host_mesh(group, data=4, model=1)
    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["cfg"])
    params = params_from_jax(case["params"], "cpu")
    prompt = torch.tensor(case["prompt"])
    rows = Placement(mesh, ("data",)).local(prompt)
    with record_collectives() as calls:
        got = make_prefill_step(cfg, mesh, device="cpu")(params, {"tokens": prompt})
    h, _ = tfm.forward_hidden(params, cfg, rows)
    out = {"axis": ModelAxis.of(cfg, mesh), "prefill": (got, tfm.unembed(params, cfg, h[:, -1:])),
           "calls": len(calls), "decode": []}
    shape = InputShape("test", seq_len=p["cache_len"], global_batch=prompt.shape[0],
                       kind="decode")
    serve, spec, placements = make_serve_step(cfg, mesh, shape, device="cpu")
    cache = local_zeros(spec, placements, "cpu")
    mine = tfm.init_cache(cfg, rows.shape[0], p["cache_len"], device="cpu")
    with record_collectives() as calls:
        for pos in range(prompt.shape[-1]):
            logits, cache = serve(params, cache, prompt[..., pos], pos)
            want, mine = tfm.decode_step(params, cfg, mine, rows[..., pos], pos)
            out["decode"].append((logits, want))
    out["decode_calls"] = len(calls)
    return out


def seeded_cache(cfg, length: int, filled: int):
    """A one-row decode cache of ``length`` positions whose first ``filled``
    hold k / v drawn from a seed, the rest zero (``chip_smoke.py``'s)."""
    from repro_torch.models import transformer as tfm

    cache = tfm.init_cache(cfg, 1, length, device="cpu")
    gen = torch.Generator().manual_seed(21)
    for layer in cache.values():
        for x in layer.values():
            x[:, :, :filled] = torch.randn(x[:, :, :filled].shape, generator=gen).to(x.dtype)
    return cache


def _tps_softmax(group, p):
    """One bf16 decode step of smoke TinyLlama on the (4, 1) mesh, its one
    row's cache sequence-sharded over the 4 ranks and seeded: each
    attention layer's combine, its inputs (this rank's logits and values),
    its fp32 sums over all ranks before the one rounding
    (``combine.fp32_sums``) and its output; the step's logits (bf16
    tensors as fp32, which holds them exactly)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.tree import tree_map

    mesh = make_host_mesh(group, data=4, model=1)
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), dtype="bfloat16", **p["cfg"])
    params = tree_map(lambda t: t.to(torch.bfloat16), params_from_jax(p["params"], "cpu"))
    records, real = [], steps._softmax_across

    def spy(pl):
        combine = real(pl)

        def recorded(logits, v_e, dtype):
            out = combine(logits, v_e, dtype)
            records.append({"logits": logits, "values": v_e.float(), "out": out.float(),
                            "sums": combine.fp32_sums(logits, v_e, dtype)})
            return out
        return recorded

    steps._softmax_across = spy
    try:
        serve, _, placements = steps.make_serve_step(
            cfg, mesh, InputShape("seeded", p["length"], 1, "decode"), device="cpu")
    finally:
        steps._softmax_across = real
    cache = tree_map(lambda x, pl: pl.local(x), seeded_cache(cfg, p["length"], p["length"] - 1),
                     placements)
    logits, _ = serve(params, cache, torch.tensor([p["token"]]), p["length"] - 1)
    return {"records": records, "logits": logits.float(), "spec": placements["0"]["k"].spec}


def project_out_inputs():
    """A seeded bf16 ``x`` [64, 256] and ``w`` [256, 96] for the row-split
    product (``test_torch_tp_serving.py``)."""
    gen = torch.Generator().manual_seed(23)
    return (torch.randn(64, 256, generator=gen).to(torch.bfloat16),
            (torch.randn(256, 96, generator=gen) / 16).to(torch.bfloat16))


def _tps_project_out(group):
    """On the (1, 4) mesh, from this rank's columns of ``x`` and rows of
    ``w``: ``ModelAxis.project_out`` on an axis whose experts are split
    (``moe``) and on one without, the bf16 partials summed by
    ``reduce_out``, and the gradients of ``sum(out * g)`` for a seeded
    ``g`` through the first and the last."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.parallel import ModelAxis

    mesh = make_host_mesh(group, data=1, model=4)
    ax = ModelAxis(mesh.axis_group("model"), mesh.coords["model"], 4, *([True] * 6))
    dense = dataclasses.replace(ax, moe=False, moe_shared=False)
    x, w = project_out_inputs()
    b = x.shape[1] // 4
    xs, ws = x[:, ax.index * b:(ax.index + 1) * b], w[ax.index * b:(ax.index + 1) * b]
    g = torch.randn(x.shape[0], w.shape[1], generator=torch.Generator().manual_seed(24))
    grads = {}
    for name, fn in (("project_out", ax.project_out),
                     ("bf16_partials", lambda a, c: ax.reduce_out(a @ c))):
        a, c = xs.clone().requires_grad_(), ws.clone().requires_grad_()
        grads[name] = [t.float() for t in torch.autograd.grad((fn(a, c).float() * g).sum(),
                                                               [a, c])]
    return {"project_out": ax.project_out(xs, ws).float(),
            "dense": dense.project_out(xs, ws).float(),
            "bf16_partials": ax.reduce_out(xs @ ws).float(), "grads": grads}


def tp_serving(rank, group, device, p):
    """Everything tests/test_torch_tp_serving.py holds, in one group: on
    each (data, model) mesh of ``p["meshes"]`` each case's prefill and
    greedy decode on compute blocks and the refusal of whole parameters;
    on the (4, 1) mesh today's route and the bf16 sequence-sharded step."""
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    for shape in p["meshes"]:
        mesh = make_host_mesh(group, *shape)
        out[tuple(shape)] = {
            "cases": {label: _tps_case(mesh, case, p) for label, case in p["cases"].items()},
            "whole_raises": _tps_whole_raises(mesh, p["cases"]["gemma"])}
    out["softmax"] = _tps_softmax(group, p["softmax"])
    out["project_out"] = _tps_project_out(group)
    out["one_model_rank"] = {label: _tps_one_model_rank(group, p["cases"][label], p)
                             for label in p["one_model_rank"]}
    return out
