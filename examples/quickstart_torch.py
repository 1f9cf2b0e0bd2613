"""Quickstart with the PyTorch port: Byzantine-robust training in ~40 lines
(the counterpart of ``examples/quickstart.py``).

Trains the paper's MLP on the heterogeneous SynthMNIST task with 25 workers,
5 of them running the mimic attack, defended by RFA + bucketing (s=2) +
worker momentum — the paper's recommended recipe (Algorithm 1 + 2).

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.base import ByzConfig  # noqa: E402
from repro_torch.data.partition import worker_datasets  # noqa: E402
from repro_torch.data.synthetic import make_train_test  # noqa: E402
from repro_torch.models.mlp import accuracy, init_mlp, nll_loss  # noqa: E402
from repro_torch.training.byzantine import ByzantineSim  # noqa: E402


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    n_workers, n_byzantine = 25, 5

    # 1. a heterogeneous federated dataset: sort-by-label non-iid split
    dev = torch.device(args.device)
    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(args.seed), n_train=4000,
                                   device=dev)
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=n_workers - n_byzantine,
                             n_byz=n_byzantine, noniid=True)

    # 2. the paper's technique as a config: bucketing + robust agg + momentum
    byz = ByzConfig(
        aggregator="rfa",        # geometric median (Weiszfeld)
        mixing="bucketing",      # Algorithm 1, camera-ready variant
        s=2,                     # paper's recommended mild mixing
        worker_momentum=0.9,     # Algorithm 2
        attack="mimic",          # what the Byzantine workers do
        n_byzantine=n_byzantine,
        delta=n_byzantine / n_workers,
    )

    # 3. train
    sim = ByzantineSim(loss_fn=nll_loss, byz=byz, n_workers=n_workers,
                       n_byzantine=n_byzantine, lr=1.0, batch_size=32, device=dev)
    params = init_mlp(torch.Generator().manual_seed(args.seed + 1), device=dev)
    _, hist = sim.run(params, torch.tensor(wx, device=dev), torch.tensor(wy, device=dev),
                      n_steps=args.steps,
                      generator=torch.Generator().manual_seed(args.seed + 2),
                      eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=50)

    for step, acc in zip(hist["step"], hist["eval"]):
        print(f"step {step:4d}  test accuracy {acc:.3f}")
    assert hist["eval"][-1] > 0.7, "defense failed!"
    print("defended against the mimic attack.")
    return hist["eval"][-1]


if __name__ == "__main__":
    main()
