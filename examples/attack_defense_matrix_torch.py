"""Sweep the attack x defense matrix with the PyTorch port and print who wins
(the counterpart of ``examples/attack_defense_matrix.py``).

A compact version of the paper's Figure 2 grid through the port's public
API — useful as a template for evaluating a new aggregator or a new attack
against the existing zoo.

    PYTHONPATH=src python examples/attack_defense_matrix_torch.py --steps 150
    PYTHONPATH=src python examples/attack_defense_matrix_torch.py --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.base import ByzConfig  # noqa: E402
from repro_torch.data.partition import worker_datasets  # noqa: E402
from repro_torch.data.synthetic import make_train_test  # noqa: E402
from repro_torch.models.mlp import accuracy, init_mlp, nll_loss  # noqa: E402
from repro_torch.training.byzantine import ByzantineSim  # noqa: E402

N, F = 15, 3
ATTACKS = ["none", "bitflip", "mimic", "ipm", "alie"]
DEFENSES = [("mean", "none"), ("rfa", "none"), ("rfa", "bucketing"), ("cclip", "bucketing")]


def run(attack, agg, mixing, task, steps, dev, seed: int = 0) -> float:
    X, Y, Xt, Yt = task
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=N - F, n_byz=F,
                             noniid=True)
    kwargs = (("n", N), ("f", F)) if attack == "alie" else ()
    byz = ByzConfig(aggregator=agg, mixing=mixing, s=2, worker_momentum=0.9,
                    attack=attack, attack_kwargs=kwargs, n_byzantine=F, delta=F / N)
    sim = ByzantineSim(loss_fn=nll_loss, byz=byz, n_workers=N, n_byzantine=F,
                       lr=1.0, batch_size=32, device=dev)
    params = init_mlp(torch.Generator().manual_seed(seed + 1), device=dev)
    _, hist = sim.run(params, torch.tensor(wx, device=dev), torch.tensor(wy, device=dev),
                      steps, torch.Generator().manual_seed(seed + 2),
                      eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=steps)
    return hist["eval"][-1]


def main(argv: Optional[List[str]] = None) -> Dict[Tuple[str, str], float]:
    """Prints the matrix and returns ``{(attack, "agg+mixing"): accuracy}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    task = make_train_test(torch.Generator().manual_seed(args.seed), n_train=3000, device=dev)
    header = "attack".ljust(10) + "".join(f"{a}+{m}".ljust(18) for a, m in DEFENSES)
    print(header)
    out = {}
    for attack in ATTACKS:
        row = attack.ljust(10)
        for agg, mixing in DEFENSES:
            acc = run(attack, agg, mixing, task, args.steps, dev, args.seed)
            out[(attack, f"{agg}+{mixing}")] = acc
            row += f"{acc:.3f}".ljust(18)
        print(row, flush=True)
    return out


if __name__ == "__main__":
    main()
