"""Analysis targets: the hot-path calls the static gate inspects (the port's
counterpart of ``repro/analysis/targets.py``).

The reference lowers each target on a forced 8-device host mesh. The port
runs each target once on each rank of 8 gloo ranks on the CPU, laid out as
the reference's mesh, ``Mesh`` (data=4, model=2) (``launch.mesh``), under
the op-trace recorder (``op_trace.trace``) and the collective recorder
(``launch.collectives.record_collectives``); ``run_on_ranks`` spawns them.
``run_on_device`` runs the targets once in this process, one rank, no mesh
(``--device cuda``: the op-trace layer on the card). Targets, with the
reference's synthetic tree (``_sync_tree``, ``SYNC_W`` = 8 workers):

  sync_fsdp_rfa_bucketing   the packed sync on the route the port's fsdp
      train step takes: worker-sharded rows (one all-to-all in), the
      sharded kernels, the param-sharded egress (``out_shardings``, one
      all-to-all out); no rank may receive the replicated fp32 [n_pad] row.
      (The reference's target takes its jnp route; the port's fsdp step
      runs the kernels, so this one does.)
  sync_kernels_{rfa,cm,cclip}_bucketing   the packed sync's kernel route
      over the group, replicated egress.
  sync_telemetry_off_rfa_bucketing   the rfa target with telemetry
      explicitly off, held exactly to the rfa target's budget.
  train_step_qwen2_5_14b_smoke   ``make_train_step`` for Qwen2.5-14B at
      ``smoke_config`` width (fsdp, server momentum) on the mesh: RFA,
      bucketing, worker momentum 0.9, seq_len 128, global batch 8; its
      param-sharded egress is held to the no-[n_pad] rule too.

Importing this module runs nothing; the rank processes import it by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.collective_lint import CollectiveCheckSpec
from repro_torch.analysis.op_trace import OpTrace, trace
from repro_torch.launch.collectives import CollectiveCall, record_collectives

MESH_DATA, MESH_MODEL = 4, 2
N_RANKS = MESH_DATA * MESH_MODEL
SYNC_W = 8            # worker rows in the standalone sync targets
TRAIN_ARCH = "qwen2.5-14b"  # fsdp + server-momentum family (smoke-sized)
TRAIN_TARGET = "train_step_qwen2_5_14b_smoke"
TRAIN_SEQ, TRAIN_BATCH = 128, 2 * MESH_DATA

#: targets that check ANOTHER target's committed budget (exact match): they
#: never own a budget file and ``--update-budgets`` writes none for them
BUDGET_ALIASES = {
    "sync_telemetry_off_rfa_bucketing": "sync_kernels_rfa_bucketing",
}


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """One target: what it runs and what the gate holds it to."""

    name: str
    description: str
    aggregator: str = "rfa"
    train: bool = False             # make_train_step, else the packed sync
    use_kernels: bool = True        # the sync's kernel route
    param_sharded: bool = False     # fsdp route: worker-sharded in, param-sharded out
    telemetry: bool = False
    budget_name: Optional[str] = None
    exact: bool = False
    expect_kernels: bool = True     # op-trace layer: a kernel must be reached
    #: a seeded violation: the param-sharded target run without its
    #: ``out_shardings`` (the replicated egress), still held to its rules
    drop_out_shardings: bool = False
    #: a seeded violation: after the param-sharded sync, a fp32 [n_pad] row
    #: gathered onto every rank from its (data, model) blocks by
    #: ``sharding.Placement.gather`` (the port's own all-gather)
    gather_row: bool = False

    def check_spec(self, n_pad: int) -> CollectiveCheckSpec:
        return CollectiveCheckSpec(
            name=self.name,
            forbid_replicated_bytes=4 * n_pad if self.param_sharded else None,
            budget_name=self.budget_name, exact=self.exact)


@dataclasses.dataclass
class TargetRun:
    """A target's run on one rank (plain values and dataclasses: it pickles)."""

    name: str
    trace: OpTrace
    calls: List[CollectiveCall]
    n_pad: int = 0


_SYNC = "packed sync, kernel route over the (4, 2) mesh, replicated egress — "
TARGETS: Dict[str, TargetSpec] = {t.name: t for t in (
    TargetSpec("sync_fsdp_rfa_bucketing", param_sharded=True, description=(
        "packed sync on the fsdp train step's route (worker-sharded rows, sharded kernels, "
        "param-sharded egress) — the no-replicated-[n_pad] invariant + collective budget")),
    TargetSpec("sync_kernels_rfa_bucketing", description=(
        _SYNC + "fused Weiszfeld (residual_norms + [W] all-reduce per iteration)")),
    TargetSpec("sync_kernels_cm_bucketing", aggregator="cm", description=(
        _SYNC + "coordinatewise median, column-local")),
    TargetSpec("sync_kernels_cclip_bucketing", aggregator="cclip", description=(
        _SYNC + "fused multi-rank CCLIP (cclip_fused_iter + [W] all-reduce)")),
    TargetSpec("sync_telemetry_off_rfa_bucketing", telemetry=False,
               budget_name=BUDGET_ALIASES["sync_telemetry_off_rfa_bucketing"], exact=True,
               description=("packed sync with telemetry explicitly OFF — must make the "
                            "byte-identical collective schedule of sync_kernels_rfa_bucketing "
                            "(exact budget match): telemetry off adds no collective")),
    TargetSpec(TRAIN_TARGET, train=True, param_sharded=True, description=(
        "full train step, smoke-sized fsdp arch with server momentum, on the (4, 2) mesh — "
        "f64 / host-sync / kernel-presence / no-replicated-[n_pad] / budget gate end to "
        "end")),
)}
TARGET_NAMES = tuple(TARGETS)


def _sync_tree(W: int, device) -> Dict[str, torch.Tensor]:
    """Synthetic fsdp-shardable gradient tree (every leaf divisible by both
    mesh axes — the shape class the param-sharded egress exists for)."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((W, 16, 48), generator=g),
            "b": torch.randn((W, 8, 64), generator=g),
            "v": torch.randn((W, 4, 256), generator=g)}
    return {k: v.to(device) for k, v in tree.items()}


def _sync_call(spec: TargetSpec, mesh, device):
    """(zero-argument call, n_pad) of a sync target on ``mesh`` (or None)."""
    from repro_torch.core.aragg import RobustAggregator
    from repro_torch.distributed.packing import packer_for
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.distributed.sharding import Placement, param_shardings
    from repro_torch.launch.mesh import n_workers
    from repro_torch.utils.tree import TensorSpec, tree_map

    tree = _sync_tree(SYNC_W, device)
    ra = RobustAggregator.from_spec(spec.aggregator, mixing="bucketing", s=2)
    mix = ra.mixing_matrix(SYNC_W, torch.Generator().manual_seed(5), device=device)
    n_pad = packer_for(tree).n_pad
    kwargs = dict(mix=mix, mesh=mesh, engine="packed", use_kernels=spec.use_kernels,
                  telemetry=spec.telemetry)
    if spec.param_sharded and mesh is not None:
        specs = tree_map(lambda x: TensorSpec(tuple(x.shape[1:]), x.dtype), tree)
        if not spec.drop_out_shardings:
            kwargs["out_shardings"] = param_shardings(specs, mesh, fsdp=True)
        # this rank's workers' rows: worker group g (its data coordinate) holds
        # rows g w .. (g+1) w - 1, as the train step passes them
        w = SYNC_W // n_workers(mesh)
        g = mesh.coords["data"]
        tree = {k: v[g * w:(g + 1) * w].contiguous() for k, v in tree.items()}
        kwargs["worker_sharded"] = True
    row = block = None
    if spec.gather_row and mesh is not None:
        row = Placement(mesh, (("data", "model"),))
        block = row.local(torch.zeros(n_pad, device=device))

    def call():
        out, _ = robust_gradient_sync(tree, ra, **kwargs)
        return out if row is None else (out, row.gather(block))

    return call, n_pad


def _train_call(spec: TargetSpec, mesh, device):
    """(zero-argument call, n_pad of the model's packed layout) of the train
    target: one step."""
    import math

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels.pairwise_gram import TILE_D
    from repro_torch.models.transformer import params_shape
    from repro_torch.utils.tree import tree_flatten

    cfg = smoke_config(TRAIN_ARCH)
    byz = ByzConfig(aggregator=spec.aggregator, mixing="bucketing", s=2,
                    worker_momentum=0.9, delta=0.1)
    step_fn, state = make_train_step(cfg, byz, mesh=mesh, n_workers=MESH_DATA,
                                     telemetry=spec.telemetry, device=device)
    g = torch.Generator().manual_seed(0)
    params = state["init_params"](g)
    opt_state = state["init_opt_state"](params)
    worker_m = state["init_worker_m"](params)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}
    mix = state["aggregator"].mixing_matrix(MESH_DATA, g, device=device)

    def call():
        return step_fn(params, opt_state, worker_m, mix, batch)

    sizes = [math.prod(x.shape) for x in tree_flatten(params_shape(cfg))[0]]
    return call, sum(-(-z // TILE_D) * TILE_D for z in sizes)


def run_target(spec: TargetSpec, mesh, device) -> TargetRun:
    """``spec`` run once in this process on ``mesh`` (``None``: one device)."""
    call, n_pad = (_train_call if spec.train else _sync_call)(spec, mesh, device)
    with record_collectives() as calls:
        _, t = trace(call, device=str(device))
    return TargetRun(spec.name, t, list(calls), n_pad)


def rank_main(rank, group, device, specs: Sequence[TargetSpec]) -> List[TargetRun]:
    """One rank's runs of ``specs`` on the (data, model) mesh of ``group``
    (``launch.mesh.spawn_ranks`` calls it in each rank)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(group, data=MESH_DATA, model=MESH_MODEL)
    return [run_target(spec, mesh, device) for spec in specs]


def resolve(names: Optional[Sequence] = None) -> List[TargetSpec]:
    """Targets by name (every target by default); a ``TargetSpec`` passes as
    it is."""
    out = []
    for n in (TARGET_NAMES if names is None else names):
        if isinstance(n, TargetSpec):
            out.append(n)
        elif n in TARGETS:
            out.append(TARGETS[n])
        else:
            raise KeyError(f"unknown analysis target {n!r}; have {sorted(TARGETS)}")
    return out


def run_on_ranks(names: Optional[Sequence] = None,
                 timeout_s: float = 600.0) -> Dict[str, List[TargetRun]]:
    """Each target on each of ``N_RANKS`` gloo ranks on the CPU (new
    processes); ``{name: [rank 0's run, ...]}``."""
    from repro_torch.launch.mesh import spawn_ranks

    specs = resolve(names)
    per_rank = spawn_ranks(rank_main, N_RANKS, backend="gloo", devices=["cpu"] * N_RANKS,
                           args=(specs,), timeout_s=timeout_s)
    return {s.name: [runs[i] for runs in per_rank] for i, s in enumerate(specs)}


def run_on_device(names: Optional[Sequence] = None,
                  device="cuda") -> Dict[str, List[TargetRun]]:
    """Each target once in this process on ``device``, one rank, no mesh."""
    dev = torch.device(device)
    return {s.name: [run_target(s, None, dev)] for s in resolve(names)}
