#!/usr/bin/env python3
"""The JAX reference's experiment loop at the scale of ``chip_smoke.py``'s
phase 9, on the CPU: the accuracies the port's run on the card is gated
against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_loop_reference.py

``repro.training.ByzantineSim`` trains the 784-128-10 MLP on SynthMNIST
(4,000 train / 1,000 test, ``benchmarks/common.py``'s scale) split non-iid
over n = 25 workers, f = 5 of them Byzantine (f = 0 where the pair has no
attack), batch 32, 300 steps, lr 0.1, with the seeds the port uses (data 0,
initial parameters 1, draws 2), for each of phase 9's runs
(``chip_smoke.PAPER_RUNS``, copied here so that this script imports no
port code). Prints one line per run and a JSON object of the accuracies.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import ByzConfig
from repro.data.partition import worker_datasets
from repro.data.synthetic import make_train_test
from repro.models.mlp import accuracy, init_mlp, nll_loss
from repro.training.byzantine import ByzantineSim

N, STEPS, BATCH = 25, 300, 32
N_TRAIN, N_TEST = 4000, 1000
#: (label, f, lr, ByzConfig fields): chip_smoke.PAPER_RUNS
RUNS = [
    ("mean/none", 0, 0.1, dict(aggregator="mean", attack="none")),
    ("krum/none vanilla", 0, 0.1, dict(aggregator="krum", mixing="none", attack="none")),
    ("krum/none s=2", 0, 0.1, dict(aggregator="krum", mixing="bucketing", s=2,
                                   attack="none")),
    ("cm+mimic vanilla", 5, 0.1, dict(aggregator="cm", mixing="none", attack="mimic")),
    ("cm+mimic s=2", 5, 0.1, dict(aggregator="cm", mixing="bucketing", s=2, attack="mimic")),
    ("rfa+bitflip s=2", 5, 0.1, dict(aggregator="rfa", mixing="bucketing", s=2,
                                     attack="bitflip")),
    ("cclip+ipm s=2", 5, 0.5, dict(aggregator="cclip", mixing="bucketing", s=2,
                                   worker_momentum=0.9, attack="ipm",
                                   attack_kwargs=(("eps", 0.1),))),
]


def main() -> None:
    X, Y, Xt, Yt = make_train_test(jax.random.PRNGKey(0), n_train=N_TRAIN, n_test=N_TEST)
    X, Y = np.asarray(X), np.asarray(Y)
    Xt, Yt = jnp.asarray(Xt), jnp.asarray(Yt)
    accs = {}
    for label, f, lr, fields in RUNS:
        t0 = time.perf_counter()
        wx, wy = worker_datasets(X, Y, n_good=N - f, n_byz=f, noniid=True)
        sim = ByzantineSim(loss_fn=nll_loss, byz=ByzConfig(n_byzantine=f, **fields),
                           n_workers=N, n_byzantine=f, lr=lr, batch_size=BATCH)
        _, hist = sim.run(init_mlp(jax.random.PRNGKey(1)), jnp.asarray(wx), jnp.asarray(wy),
                          STEPS, jax.random.PRNGKey(2),
                          eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=STEPS)
        accs[label] = hist["eval"][-1]
        print(f"{label}: n {N}, f {f}, {STEPS} steps, lr {lr}: test accuracy "
              f"{accs[label]:.4f} ({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    print(json.dumps({"reference_accuracy": accs}))


if __name__ == "__main__":
    main()
