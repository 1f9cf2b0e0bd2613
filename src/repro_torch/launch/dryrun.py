"""Dry-run of the production mesh on fake ranks: the port's counterpart of
``repro/launch/dryrun.py``.

For each (architecture x input shape) combination this process acts as one
rank of the reference's production mesh, ``(16, 16)`` over ``("data",
"model")`` (256 ranks) or with ``--multi-pod`` ``(2, 16, 16)`` (512), and
runs the step for the shape's kind once: ``make_train_step`` for ``train``,
``make_prefill_step`` for ``prefill``, ``make_serve_step`` for ``decode``.
Nothing runs on a card and no other rank exists:

- the process group is PyTorch's ``"fake"`` backend
  (``torch.testing._internal.distributed.fake_pg.FakeStore``): every
  collective returns at once, so one process is rank r of 256;
- the step runs under ``FakeTensorMode`` on fake CUDA tensors, which carry
  shapes and dtypes and hold no memory; parameters, optimizer state and
  worker momenta come from the port's own init, cut to this rank's blocks
  by ``distributed/sharding.py``; a serving step's parameters are this
  rank's compute blocks (``sharding.compute_shardings``), made as fresh
  tensors, so its ``argument`` prices what a serving rank holds. A
  CPU-only build of PyTorch cannot copy even a fake tensor to CUDA
  (``.to("cuda")`` raises), so there the same trace runs on fake CPU
  tensors (``trace_device``): shapes, dtypes, bytes, operations and
  collectives are the same;
- the kernel wrappers, handed a fake tensor, launch nothing and record the
  call's bytes and operations (``kernels/cost.py``).

Under the fake backend the collectives take the route a multi-card NCCL
run takes (``shard_kernels.exchange`` and ``sharding._gather_along`` stage
through the host only under gloo).

Each combination reports the reference's keys: ``flops``
(``FlopCounterMode``'s per-op formulas plus the kernels' operations),
``bytes_hbm`` (each ATen op's input and output bytes, as eager mode moves
them, plus the kernels' bytes),
``collectives`` (received bytes per kind, ``launch/collectives.py``), the
roofline terms and ``bytes_per_device`` (``argument``: the tensors the step
is handed; ``output``: those it returns; ``peak`` from
``torch.distributed._tools.mem_tracker.MemTracker`` on this rank;
``temp`` = peak - argument). ``trace_s`` takes the place of ``lower_s`` /
``compile_s``. XLA's scan extrapolation has no counterpart: every layer is
traced.

The roofline constants are the card's: NVIDIA H100 80GB HBM3 (SXM5, 700 W),
data-sheet figures, 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s
NVLink a direction. The collective term is the in-node NVLink bound: a
(16, 16) mesh spans 32 nodes of 8 cards, whose links across nodes are
slower, so the term is a lower bound.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \
        --remat none [--layers 2]

``--layers N`` cuts the depth, ``--remat none|full`` replaces the config's
``remat`` field (``dryrun_one``'s ``overrides``).

The fake group exists only inside ``main()`` or an explicit ``activate()``:
importing this module creates no group and sets no variable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import INPUT_SHAPES, ByzConfig, get_config, list_archs
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch.collectives import collective_bytes, record_collectives
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils.tree import tree_flatten

#: NVIDIA H100 80GB HBM3 (SXM5, 700 W), data sheet: dense bf16 tensor-core
#: op/s, HBM3 bytes/s, NVLink bytes/s a direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def roofline_terms(flops: float, bytes_hbm: float, coll: Dict[str, int]):
    """The reference's roofline terms for one rank: its operations, HBM
    bytes and received collective bytes, each over one card's rate (the
    ranks of the mesh run alike, so the mesh takes as long as one)."""
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    total_coll = float(sum(coll.values()))
    t_coll = total_coll / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    terms["collective_bytes"] = total_coll
    return terms


def trace_device() -> torch.device:
    """Where the fake tensors lie: CUDA where PyTorch is built with it (no
    card is needed), else the CPU."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def activate(n_ranks: int = 512, rank: int = 0) -> None:
    """Join this process to a ``"fake"`` process group of ``n_ranks`` ranks
    as ``rank`` (the counterpart of the reference's ``activate()``, which
    forces placeholder devices). A group already open is closed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n_ranks)


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj``: a tensor, or a list / tuple of them."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    return 0


class _CostMode(TorchDispatchMode):
    """One pass over the ATen ops a step dispatches: ``flops`` by
    ``FlopCounterMode``'s own per-op formulas (``flop_registry``, so the
    total is ``FlopCounterMode().get_total_flops()``), and ``bytes``, those
    of every tensor an op reads and writes, as eager mode moves them (views
    and metadata-only ops move none). One mode where two would each pay
    the dispatch again."""

    _FREE = ("view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
             "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach",
             "lift_fresh", "unbind", "split", "split_with_sizes", "chunk", "narrow",
             "_reshape_alias", "empty", "empty_strided", "new_empty", "new_empty_strided")

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "aten" and packet.__name__ not in self._FREE:
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(tuple(kwargs.values()))
                           + _tensor_bytes(out))
        return out


def _nbytes(*trees) -> int:
    """Bytes of the distinct storages among the tensors of ``trees``."""
    seen, n = set(), 0
    for tree in trees:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage()._cdata not in seen:
                seen.add(t.untyped_storage()._cdata)
                n += t.untyped_storage().nbytes()
    return n


def _zeros(specs, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def make_step(cfg, shape, mesh, byz, dev):
    """``(run, arguments)``: the step of ``shape.kind`` on ``mesh`` with its
    arguments (this rank's blocks), made inside the caller's fake mode;
    ``run()`` returns the step's outputs."""
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import compute_shardings, local_zeros
    from repro_torch.models import transformer as tfm

    specs = steps.input_specs(cfg, shape)
    if shape.kind == "train":
        step_fn, state = steps.make_train_step(cfg, byz, mesh, device=dev)
        # draws on the (fake) CPU; init moves them to dev
        params = state["init_params"](torch.Generator())
        opt_state = state["init_opt_state"](params)
        worker_m = state["init_worker_m"](params)
        batch = _zeros(specs, dev)
        args = (params, opt_state, worker_m, None, batch)
        return (lambda: step_fn(*args)), args
    # serving: this rank's compute blocks, fresh tensors (whole leaves
    # where the model axis has one rank)
    specs_p = tfm.params_shape(cfg)
    params = local_zeros(specs_p, compute_shardings(cfg, specs_p, mesh), device=dev)
    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(cfg, mesh, device=dev)
        batch = _zeros(specs, dev)
        return (lambda: prefill(params, batch)), (params, batch)
    serve, cache_spec, cache_pl = steps.make_serve_step(cfg, mesh, shape, device=dev)
    cache = local_zeros(cache_spec, cache_pl, device=dev)
    token = _zeros(specs, dev)["token"]
    position = shape.seq_len - 1
    return (lambda: serve(params, cache, token, position)), (params, cache, token)


def dryrun_one(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    byz: Optional[ByzConfig] = None,
    verbose: bool = True,
    overrides: Optional[dict] = None,
) -> Dict:
    """Trace one (arch, shape, mesh) combination on this fake rank (module
    docstring). The process must be in a fake group of the mesh's size
    (``activate``). ``overrides`` replace config fields (``n_layers`` cuts
    depth)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    byz = byz or ByzConfig(aggregator="rfa", mixing="bucketing", s=2, worker_momentum=0.9,
                           delta=0.1)

    # --- applicability gates (the reference's DESIGN.md §6)
    if shape.kind == "decode" and shape_name == "long_500k":
        if cfg.long_context == "window" and cfg.long_context_window <= 0:
            return {"skipped": "full-attention arch without window variant"}

    mesh = make_production_mesh(dist.group.WORLD, multi_pod=multi_pod)
    n_chips = mesh.size
    dev = trace_device()
    t0 = time.time()
    kernel_cost.reset()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, args = make_step(cfg, shape, mesh, byz, dev)
        argument = _nbytes(args)
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_flatten(args)[0]
                                 if isinstance(t, torch.Tensor)])
        counted = _CostMode()
        with record_collectives() as calls, tracker, counted:
            out = run()
        output = _nbytes(out)
        snap = tracker.get_tracker_snapshot("peak")
    trace_s = time.time() - t0
    k_bytes, k_ops = kernel_cost.totals()
    total_flops = float(counted.flops) + k_ops
    bytes_hbm = float(counted.bytes) + k_bytes
    coll = collective_bytes(calls)
    peak = max(int(s.get("Total", 0)) for s in snap.values()) if snap else 0
    terms = roofline_terms(total_flops, bytes_hbm, coll)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "flops": total_flops,
        "bytes_hbm": bytes_hbm,
        "collectives": coll,
        **terms,
        "trace_s": round(trace_s, 1),
        "bytes_per_device": {"argument": argument, "output": output,
                             "temp": max(0, peak - argument), "peak": peak},
        "kernels": {k: dict(v) for k, v in kernel_cost.COSTS.items()},
    }
    if verbose:
        cut = "".join(f", {k}={v}" for k, v in (overrides or {}).items())
        print(f"== {arch} x {shape_name} x {result['mesh']} ({shape.kind}{cut}) ==")
        print("memory_analysis:", result["bytes_per_device"])
        print(f"cost_analysis: flops={total_flops:.3e} bytes={bytes_hbm:.3e} "
              f"collective_bytes={terms['collective_bytes']:.3e}")
        print(f"roofline: compute={terms['compute_s'] * 1e3:.2f}ms "
              f"memory={terms['memory_s'] * 1e3:.2f}ms "
              f"collective={terms['collective_s'] * 1e3:.2f}ms "
              f"-> bottleneck: {terms['bottleneck']}")
        print(f"(trace {trace_s:.1f}s)", flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--agg", type=str, default="rfa")
    ap.add_argument("--mixing", type=str, default="bucketing")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (for a hybrid, a multiple of its period)")
    ap.add_argument("--remat", type=str, default=None, choices=("none", "full"),
                    help="replace the config's remat field")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]
    activate(512 if args.multi_pod else 256)
    byz = ByzConfig(aggregator=args.agg, mixing=args.mixing, s=2, worker_momentum=0.9,
                    delta=0.1)
    overrides = {k: v for k, v in (("n_layers", args.layers), ("remat", args.remat)) if v}
    results = []
    try:
        for arch, shape in combos:
            try:
                results.append(dryrun_one(arch, shape, args.multi_pod, byz,
                                          overrides=overrides))
            except Exception as e:  # noqa: BLE001 - report and continue the sweep
                print(f"!! {arch} x {shape} FAILED: {type(e).__name__}: {e}", flush=True)
                results.append({"arch": arch, "shape": shape, "error": str(e)[:500]})
    finally:
        dist.destroy_process_group()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    failed = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(failed)}/{len(results)} combinations traced")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
