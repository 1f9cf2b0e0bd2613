#!/usr/bin/env python3
"""The JAX reference's experiment loop with the CNN of App. Table 5, at the
scale of ``chip_smoke.py``'s phase 16(a), on the CPU: the accuracies the
port's CNN runs on the card are gated against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_loop_cnn_reference.py

As ``scripts/paper_loop_reference.py`` (SynthMNIST, 4,000 train / 1,000
test, split non-iid over n = 25 workers, f of them Byzantine, batch 32, 300
steps, seeds data 0, parameters 1, draws 2) with
``repro.models.mlp.init_cnn`` (scale 1) and ``cnn_nll_loss`` for each of
phase 16(a)'s runs (``chip_smoke.CNN_RUNS``: two of phase 9's pairs with
their learning rates, copied here so that this script imports no port
code), and for two more of phase 9's pairs at its lr 0.1, rfa+bitflip and
cm+mimic, whose CNN does not leave chance in 300 steps (why phase 16(a)
does not run them). Prints one line per run with the test accuracy every
50 steps, and a JSON object of the final accuracies.
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
from repro.models.mlp import cnn_apply, cnn_nll_loss, init_cnn
from repro.training.byzantine import ByzantineSim

N, STEPS, BATCH = 25, 300, 32
N_TRAIN, N_TEST = 4000, 1000
#: (label, f, lr, ByzConfig fields): chip_smoke.CNN_RUNS
RUNS = [
    ("cnn cclip+ipm s=2", 5, 0.5, dict(aggregator="cclip", mixing="bucketing", s=2,
                                       worker_momentum=0.9, attack="ipm",
                                       attack_kwargs=(("eps", 0.1),))),
    ("cnn mean/none", 0, 0.1, dict(aggregator="mean", attack="none")),
]
#: phase 9's pairs the CNN does not learn with in 300 steps (not gated)
AT_CHANCE = [
    ("cnn rfa+bitflip s=2", 5, 0.1, dict(aggregator="rfa", mixing="bucketing", s=2,
                                         attack="bitflip")),
    ("cnn cm+mimic s=2", 5, 0.1, dict(aggregator="cm", mixing="bucketing", s=2,
                                      attack="mimic")),
]


def accuracy(params, x, y):
    return jnp.mean((jnp.argmax(cnn_apply(params, x), axis=-1) == y).astype(jnp.float32))


def main() -> None:
    X, Y, Xt, Yt = make_train_test(jax.random.PRNGKey(0), n_train=N_TRAIN, n_test=N_TEST)
    X, Y = np.asarray(X), np.asarray(Y)
    Xt, Yt = jnp.asarray(Xt), jnp.asarray(Yt)
    accs = {}
    for label, f, lr, fields in RUNS + AT_CHANCE:
        t0 = time.perf_counter()
        wx, wy = worker_datasets(X, Y, n_good=N - f, n_byz=f, noniid=True)
        sim = ByzantineSim(loss_fn=cnn_nll_loss, byz=ByzConfig(n_byzantine=f, **fields),
                           n_workers=N, n_byzantine=f, lr=lr, batch_size=BATCH)
        _, hist = sim.run(init_cnn(jax.random.PRNGKey(1)), jnp.asarray(wx), jnp.asarray(wy),
                          STEPS, jax.random.PRNGKey(2),
                          eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=50)
        accs[label] = hist["eval"][-1]
        curve = ", ".join(f"{s}: {a:.3f}" for s, a in zip(hist["step"], hist["eval"]))
        print(f"{label}: n {N}, f {f}, {STEPS} steps, lr {lr}: test accuracy "
              f"{accs[label]:.4f} (by step: {curve}; {time.perf_counter() - t0:.1f} s on the "
              "CPU)", flush=True)
    print(json.dumps({"reference_accuracy": accs}))


if __name__ == "__main__":
    main()
