"""The port's cross-device loop held against the reference (paper Remark 7).

Same data, same starting parameters (``params_from_jax``) and the
reference's own draws (cohort, batch indices, mixing matrix): one round for
every rule and five rounds for rfa and cm must give the reference's
parameters. The port's own 120-round runs, drawing from a
``torch.Generator``, must reach the thresholds of tests/test_cross_device.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzConfig as RByzConfig
from repro.data.partition import worker_datasets
from repro.data.synthetic import make_train_test
from repro.models.mlp import init_mlp as rinit_mlp
from repro.models.mlp import nll_loss as rnll_loss
from repro.training.cross_device import CrossDeviceSim as RCrossDeviceSim
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.mlp import accuracy, nll_loss
from repro_torch.training.cross_device import CrossDeviceSim, Draws

SIM = dict(n_clients=50, byz_frac=0.1, clients_per_round=10, lr=1.0, batch_size=16,
           server_momentum=0.9)
RULES = ["mean", "krum", "cm", "tm", "rfa", "cclip", "acclip"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and torch's default of one thread a core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    X, Y, Xt, Yt = make_train_test(jax.random.PRNGKey(0), n_train=3000, n_test=500)
    wx, wy = worker_datasets(X, Y, n_good=45, n_byz=5, noniid=True)
    return (np.asarray(wx), np.asarray(wy), np.asarray(Xt), np.asarray(Yt))


@pytest.fixture(scope="module")
def params_np():
    return {k: np.asarray(v) for k, v in rinit_mlp(jax.random.PRNGKey(1)).items()}


def _byz(cls, agg, attack):
    kwargs = (("n", 10), ("f", 2)) if attack == "alie" else ()
    return cls(aggregator=agg, mixing="bucketing", s=2, attack=attack,
               attack_kwargs=kwargs, n_byzantine=0)


def _reference_draws(rsim, key, n_samples):
    """What the reference's ``step`` draws from ``key``."""
    k_sample, k_batch, _, k_agg = jax.random.split(key, 4)
    C = rsim.clients_per_round
    cohort = jax.random.randint(k_sample, (C,), 0, rsim.n_clients)
    idx = jax.random.randint(k_batch, (C, rsim.batch_size), 0, n_samples)
    mix = rsim.aggregator.mixing_matrix(k_agg, C)
    return Draws(torch.tensor(np.asarray(cohort), dtype=torch.long),
                 torch.tensor(np.asarray(idx), dtype=torch.long),
                 torch.tensor(np.asarray(mix)))


def _lockstep(pool, params_np, agg, attack, rounds):
    wx, wy, _, _ = pool
    rsim = RCrossDeviceSim(loss_fn=rnll_loss, byz=_byz(RByzConfig, agg, attack), **SIM)
    tsim = CrossDeviceSim(loss_fn=nll_loss, byz=_byz(ByzConfig, agg, attack),
                          device="cpu", **SIM)
    rstate = rsim.init_state({k: jnp.asarray(v) for k, v in params_np.items()})
    tstate = tsim.init_state(params_from_jax(params_np, device="cpu"))
    twx, twy = torch.tensor(wx), torch.tensor(wy)
    for t in range(rounds):
        key = jax.random.PRNGKey(100 + t)
        rstate, _ = rsim.step(rstate, jnp.asarray(wx), jnp.asarray(wy), key)
        tstate, _ = tsim.step(tstate, twx, twy, _reference_draws(rsim, key, wx.shape[1]))
    for k, v in rstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tstate.server_m.numpy(), np.asarray(rstate.server_m),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("agg", RULES)
def test_one_round_matches_reference(pool, params_np, agg):
    _lockstep(pool, params_np, agg, "bitflip", rounds=1)


@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_five_rounds_match_reference(pool, params_np, agg):
    _lockstep(pool, params_np, agg, "bitflip", rounds=5)


@pytest.mark.parametrize("attack,agg,threshold", [("none", "rfa", 0.75),
                                                  ("bitflip", "rfa", 0.7),
                                                  ("ipm", "acclip", 0.7)])
def test_port_learns_on_reference_data(pool, params_np, attack, agg, threshold):
    wx, wy, Xt, Yt = pool
    sim = CrossDeviceSim(loss_fn=nll_loss, byz=_byz(ByzConfig, agg, attack),
                         device="cpu", **SIM)
    Xt, Yt = torch.tensor(Xt), torch.tensor(Yt)
    _, hist = sim.run(params_from_jax(params_np, device="cpu"), torch.tensor(wx),
                      torch.tensor(wy), 120, torch.Generator().manual_seed(2),
                      eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=120)
    assert hist["round"] == [120]
    assert hist["eval"][-1] > threshold
