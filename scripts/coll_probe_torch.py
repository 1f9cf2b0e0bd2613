"""Attribute collective bytes per call for one (arch, shape) train step of the
PyTorch port on the fake production mesh, then compare the packed engine's
two egress modes there (the counterpart of ``scripts/coll_probe.py``).

The step runs once as rank 0 of a ``"fake"`` process group of 256 ranks,
the ``(16, 16)`` mesh over ``("data", "model")``, under ``FakeTensorMode``
(``repro_torch.launch.dryrun``): nothing runs on a card and nothing is
sent. Each ``torch.distributed`` call is recorded with the bytes it fills
on this rank and the port's function that made it
(``launch/collectives.record_collectives``). The egress comparison runs the
packed sync alone on a synthetic fsdp-shardable tree with the rows
worker-sharded, as the train step hands them: the replicated egress (every
rank gets the whole fp32 ``[n_pad]`` row) against the param-sharded one
(``out_shardings``: each rank gets its blocks).

Every result is also a ``probe`` event through
``repro_torch.telemetry.EventLog``; ``--jsonl PATH`` keeps them.

    PYTHONPATH=src python scripts/coll_probe_torch.py [arch] [agg] [--smoke] [--jsonl out.jsonl]
"""

import argparse
import os
import sys


def main(argv=None):
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="tinyllama-1.1b")
    ap.add_argument("agg", nargs="?", default="rfa")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke_config width")
    ap.add_argument("--jsonl", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import INPUT_SHAPES, get_config, smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.packing import packer_for
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch import dryrun
    from repro_torch.launch.collectives import collective_bytes, record_collectives
    from repro_torch.launch.mesh import make_production_mesh, n_workers
    from repro_torch.telemetry import EventLog
    from repro_torch.utils.tree import TensorSpec

    dryrun.activate(256)
    try:
        mesh = make_production_mesh(dist.group.WORLD)
        byz = ByzConfig(aggregator=args.agg, mixing="bucketing", s=2, worker_momentum=0.9,
                        delta=0.1)
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        log = EventLog(args.jsonl, run_id="coll_probe_torch")
        log.run_meta(script="coll_probe_torch", arch=cfg.name, aggregator=args.agg,
                     shape=args.shape, n_ranks=mesh.size)
        dev = dryrun.trace_device()
        with FakeTensorMode(allow_non_fake_inputs=True):
            run, _ = dryrun.make_step(cfg, INPUT_SHAPES[args.shape], mesh, byz, dev)
            with record_collectives() as calls:
                run()
        rows = sorted(((c.received, c.kind, c.site) for c in calls), reverse=True)
        total = sum(r[0] for r in rows)
        print(f"{cfg.name} x {args.shape} on {mesh.size} fake ranks: {total / 1e9:.3f} GB "
              f"received by rank 0 in {len(rows)} calls")
        for b, kind, site in rows[:15]:
            print(f"{b / 1e9:8.3f}GB {kind:14s} {site}")
        log.probe("train_collectives", {
            "arch": cfg.name, "aggregator": args.agg, "total_bytes": total,
            "n_ops": len(rows),
            "top_ops": [{"bytes": b, "kind": k, "op_name": s} for b, k, s in rows[:15]]})

        # ---- egress modes: replicated row vs param-sharded blocks
        W = n_workers(mesh)
        w_local = 1  # one worker a worker group, as the train step holds them
        shapes = {"wq": (2048, 2048), "wff": (2048, 8192)}
        out_sh = param_shardings({k: TensorSpec(v, torch.float32) for k, v in shapes.items()},
                                 mesh, fsdp=True)
        aggregator = byz.make_aggregator(W)
        result = {}
        with FakeTensorMode(allow_non_fake_inputs=True):
            tree = {k: torch.zeros((w_local,) + v, device=dev) for k, v in shapes.items()}
            n_pad = packer_for(tree).n_pad
            for name, osh in (("replicated", None), ("param_sharded", out_sh)):
                with record_collectives() as calls:
                    robust_gradient_sync(tree, aggregator, mesh=mesh, engine="packed",
                                         out_shardings=osh, worker_sharded=True)
                row = any(("float32", n_pad) == b for c in calls for b in c.buffers)
                result[name] = {"total_bytes": sum(c.received for c in calls),
                                "by_kind": collective_bytes(calls),
                                "npad_row_materialized": row}
        print(f"\negress comparison ({W} workers, n_pad={n_pad}):")
        for name, r in result.items():
            print(f"  {name:13s}: {r['total_bytes'] / 1e9:.3f} GB  {r['by_kind']}  "
                  f"(f32[{n_pad}] filled: {r['npad_row_materialized']})")
        log.probe("egress_comparison", {"n_workers": W, "n_pad": n_pad, **result})
        log.close()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
