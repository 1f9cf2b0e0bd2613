"""Rank bodies for tests/test_torch_shard_engine.py.

``run_all`` runs in every process of a gloo group on the CPU
(``repro_torch.launch.mesh.spawn_ranks``). This module imports torch and
the port only, so the rank processes never import jax; the test modules
compute the JAX side and hand the ranks the same numpy inputs and the
reference's mixing matrices. ``run_telemetry`` serves
tests/test_torch_telemetry.py; ``run_train`` the worker-sharded train step;
``train_step_refusals`` tests/test_torch_train.py.
"""

import contextlib

import torch

from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import packing, shard_kernels
from repro_torch.distributed.robust_sync import robust_gradient_sync

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
    """What ``make_train_step`` refuses over a group: an fsdp config (its
    param-sharded egress is not ported) and workers that do not split over
    the ranks; the message of each refusal."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step

    cfg = smoke_config("tinyllama-1.1b")
    out = {}
    for label, c, n in (("fsdp", dataclasses.replace(cfg, fsdp=True), 2),
                        ("uneven", cfg, 3)):
        try:
            make_train_step(c, ByzConfig(), mesh=group, n_workers=n, device=device)
        except (NotImplementedError, ValueError) as e:
            out[label] = f"{type(e).__name__}: {e}"
    return out


def fail_on_rank_one(rank, group, device):
    """Rank 1 raises while rank 0 hangs, as a rank stuck in a collective
    would."""
    if rank == 1:
        raise ValueError("rank one fails")
    import time

    time.sleep(600)
