"""End-to-end driver: Byzantine-robust training of an LLM with the PyTorch
port (the counterpart of ``examples/train_llm_byzantine.py``).

The port's distributed stack end to end: a mesh of ranks, the train step
with the robust gradient sync in place of the mean all-reduce, worker
momentum, the synthetic heterogeneous token pipeline (per-worker bigram
"dialects"), then a checkpoint in the reference's layout (the JAX
package's ``restore_checkpoint`` reads it).

    PYTHONPATH=src python examples/train_llm_byzantine_torch.py --steps 200 --device cpu
    PYTHONPATH=src python examples/train_llm_byzantine_torch.py --arch mamba2-130m --preset full
    # 4 ranks of a gloo group (on one card, or the CPU), one worker each:
    PYTHONPATH=src python examples/train_llm_byzantine_torch.py --ranks 4 --device cpu

With ``--ranks R`` the script spawns R processes that form one gloo group,
laid out as the mesh ``(data=R, model=1)``; each rank trains its own
workers and holds its blocks of an fsdp config's parameters, and the
checkpoint gathers them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ByzConfig  # noqa: E402
from repro_torch.data.synthetic import make_token_stream  # noqa: E402
from repro_torch.distributed.steps import make_train_step  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, n_workers, spawn_ranks  # noqa: E402
from repro_torch.training.checkpoint import save_checkpoint  # noqa: E402


def train(rank, group, device, args) -> float:
    """The training loop on one rank (``group`` None: one process); returns
    the last loss."""
    cfg = smoke_config(args.arch) if args.preset == "cpu" else get_config(args.arch)
    if args.preset == "full":
        cfg = dataclasses.replace(cfg, dtype="float32")
    mesh = None if group is None else make_host_mesh(group, data=args.ranks)
    W = 1 if mesh is None else n_workers(mesh)
    byz = ByzConfig(aggregator=args.agg, mixing=args.mixing, s=2, worker_momentum=0.9,
                    delta=0.1)
    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count():,} workers={W} "
              f"agg={args.agg}+{args.mixing} device={device}", flush=True)

    step_fn, state = make_train_step(cfg, byz, mesh, lr=args.lr, optimizer="adamw",
                                     device=device)
    params = state["init_params"](torch.Generator(device=device).manual_seed(0))
    opt_state = state["init_opt_state"](params)
    worker_m = state["init_worker_m"](params)

    # heterogeneous per-worker token streams (non-iid "dialects"), the same
    # draws on every rank
    streams = make_token_stream(torch.Generator().manual_seed(1), n_workers=W,
                                seq_len=args.seq_len, n_seqs_per_worker=64,
                                vocab=cfg.vocab_size, device=device)
    aggregator = state["aggregator"]
    picks = torch.Generator().manual_seed(2)
    t0 = time.time()
    loss = float("nan")
    for t in range(args.steps):
        idx = torch.randint(0, streams.shape[1], (W, args.batch // W), generator=picks)
        seqs = torch.gather(streams, 1, idx.to(device)[..., None].expand(-1, -1,
                                                                          streams.shape[2]))
        seqs = seqs.reshape(args.batch, -1)
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        mix = aggregator.mixing_matrix(W, picks, device=device)
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix, batch)
        loss = float(metrics["loss"])
        if rank == 0 and (t % 20 == 0 or t == args.steps - 1):
            print(f"step {t:5d}  loss {loss:.4f}  ({time.time() - t0:.0f}s)", flush=True)

    sh = state["shardings"]
    path = save_checkpoint(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state},
                           shardings=None if sh is None else
                           {"params": sh["params"], "opt": sh["opt_state"]})
    if rank == 0:
        print(f"checkpoint -> {path}", flush=True)
    return loss


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--preset", choices=["cpu", "full"], default="cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--agg", default="rfa")
    ap.add_argument("--mixing", default="bucketing")
    ap.add_argument("--ckpt-dir", default="repro_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many ranks of a gloo group (0: one process)")
    args = ap.parse_args()
    if args.ranks:
        spawn_ranks(train, args.ranks, backend="gloo", devices=[args.device] * args.ranks,
                    args=(args,), timeout_s=24 * 3600)
    else:
        train(0, None, args.device, args)


if __name__ == "__main__":
    main()
