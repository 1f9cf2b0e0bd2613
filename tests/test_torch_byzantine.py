"""The port's experiment loop (``ByzantineSim``), its minibatch pipeline, the
paper's MNIST config and the theory module, held against the reference.

Same data, same starting parameters (``params_from_jax``) and the
reference's own draws (batch indices from ``k_batch``, the mixing matrix
from ``aggregator.mixing_matrix(k_agg, n)``): one step for every rule, five
steps with the stateful mimic attack, and both momentum conventions must
give the reference's parameters and momenta. The port's own runs, drawing
from a ``torch.Generator``, must reach the thresholds of tests/test_sim.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.configs.base import ByzConfig as RByzConfig
from repro.core import theory as rtheory
from repro.data.partition import worker_datasets
from repro.data.pipeline import sample_token_batches as rsample_token_batches
from repro.data.pipeline import sample_worker_batches as rsample_worker_batches
from repro.data.synthetic import make_train_test
from repro.models.mlp import init_mlp as rinit_mlp
from repro.models.mlp import nll_loss as rnll_loss
from repro.training.byzantine import ByzantineSim as RByzantineSim
from repro.training.byzantine import label_flip_targets as rlabel_flip_targets
from repro_torch import configs
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import theory
from repro_torch.data.pipeline import (draw_batch_idx, sample_token_batches,
                                       sample_worker_batches)
from repro_torch.models.mlp import accuracy, init_mlp, nll_loss
from repro_torch.training.byzantine import ByzantineSim, Draws, label_flip_targets

N, F = 10, 2
SIM = dict(n_workers=N, n_byzantine=F, lr=0.1, batch_size=16)
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
def task():
    X, Y, Xt, Yt = make_train_test(jax.random.PRNGKey(0), n_train=3000, n_test=600)
    return np.asarray(X), np.asarray(Y), np.asarray(Xt), np.asarray(Yt)


@pytest.fixture(scope="module")
def workers(task):
    X, Y, _, _ = task
    wx, wy = worker_datasets(X, Y, n_good=N - F, n_byz=F, noniid=True)
    return np.asarray(wx), np.asarray(wy)


@pytest.fixture(scope="module")
def params_np():
    return {k: np.asarray(v) for k, v in rinit_mlp(jax.random.PRNGKey(1)).items()}


def _byz(cls, agg, attack, **kw):
    kwargs = (("n", N), ("f", F)) if attack == "alie" else ()
    return cls(aggregator=agg, mixing="bucketing", s=2, attack=attack,
               attack_kwargs=kwargs, n_byzantine=F, **kw)


def _reference_draws(rsim, key, m):
    """What the reference's ``step`` draws from ``key`` (the attack's key
    draws nothing in any attack)."""
    k_batch, _, k_agg = jax.random.split(key, 3)
    idx = jax.random.randint(k_batch, (rsim.n_workers, rsim.batch_size), 0, m)
    mix = rsim.aggregator.mixing_matrix(k_agg, rsim.n_workers)
    return Draws(torch.tensor(np.asarray(idx), dtype=torch.long),
                 torch.tensor(np.asarray(mix)))


def _lockstep(workers, params_np, agg, attack, steps, telemetry=False, **byz_kw):
    """Both sims from the same start through the reference's draws; returns
    the two final states and the last step's metrics."""
    wx, wy = workers
    rsim = RByzantineSim(loss_fn=rnll_loss, byz=_byz(RByzConfig, agg, attack, **byz_kw),
                         telemetry=telemetry, **SIM)
    tsim = ByzantineSim(loss_fn=nll_loss, byz=_byz(ByzConfig, agg, attack, **byz_kw),
                        telemetry=telemetry, device="cpu", **SIM)
    rstate = rsim.init_state({k: jnp.asarray(v) for k, v in params_np.items()})
    tstate = tsim.init_state(params_from_jax(params_np, device="cpu"))
    twx, twy = torch.tensor(wx), torch.tensor(wy)
    for t in range(steps):
        key = jax.random.PRNGKey(100 + t)
        rstate, rmetrics = rsim.step(rstate, jnp.asarray(wx), jnp.asarray(wy), key)
        tstate, tmetrics = tsim.step(tstate, twx, twy, _reference_draws(rsim, key, wx.shape[1]))
    for k, v in rstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tstate.momentum.numpy(), np.asarray(rstate.momentum),
                               rtol=1e-4, atol=1e-6)
    assert tstate.step == int(rstate.step) == steps
    return (rstate, rmetrics), (tstate, tmetrics)


# ------------------------------------------------------------ lockstep
@pytest.mark.parametrize("agg", RULES)
def test_one_step_matches_reference(workers, params_np, agg):
    (_, rm), (_, tm) = _lockstep(workers, params_np, agg, "bitflip", steps=1)
    for name in ("grad_norm_mean", "agg_norm", "zeta_sq"):
        np.testing.assert_allclose(float(tm[name]), float(rm[name]), rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_five_steps_with_mimic_match_reference(workers, params_np, agg):
    """The mimic attack carries its state (Oja's direction, the scores, the
    mimicked worker) from step to step."""
    (rs, _), (ts, _) = _lockstep(workers, params_np, agg, "mimic", steps=5)
    assert int(ts.attack_state.i_star) == int(rs.attack_state.i_star)
    assert int(ts.attack_state.t) == int(rs.attack_state.t) == 5
    np.testing.assert_allclose(ts.attack_state.score.numpy(), np.asarray(rs.attack_state.score),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("convention", ["ema", "pytorch"])
def test_momentum_conventions_match_reference(workers, params_np, convention):
    _lockstep(workers, params_np, "rfa", "bitflip", steps=3, momentum_convention=convention,
              worker_momentum=0.5)


@pytest.mark.parametrize("agg", ["rfa", "krum", "cm", "tm", "cclip", "acclip", "mean"])
def test_one_step_telemetry_matches_reference(workers, params_np, agg):
    """``telemetry=True``: the step's stats tree has the reference's names
    and values."""
    (_, rm), (_, tm) = _lockstep(workers, params_np, agg, "alie", steps=1, telemetry=True)
    rtele, ttele = rm["telemetry"], tm["telemetry"]
    assert sorted(ttele) == sorted(rtele)
    for name, want in rtele.items():
        got = ttele[name]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        if np.asarray(want).dtype.kind in "bi":
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_telemetry_leaves_the_run_as_it_was(workers, params_np):
    """The stats form runs the plain form's operations: with telemetry on,
    parameters and momenta equal telemetry off's bit for bit, and only the
    history gains ``telemetry``."""
    wx, wy = (torch.tensor(a) for a in workers)
    finals = {}
    for telemetry in (False, True):
        sim = ByzantineSim(loss_fn=nll_loss, byz=_byz(ByzConfig, "rfa", "mimic"),
                           telemetry=telemetry, device="cpu", **SIM)
        state, hist = sim.run(params_from_jax(params_np, device="cpu"), wx, wy, 3,
                              torch.Generator().manual_seed(4))
        finals[telemetry] = state
    assert sorted(hist) == ["eval", "step", "telemetry", "zeta_sq"]
    assert hist["telemetry"]["rfa_resid_norms"].shape == (3, 8, N // 2)
    assert hist["telemetry"]["byz_mask"].shape == (3, N)
    for k, v in finals[False].params.items():
        assert torch.equal(v, finals[True].params[k]), k
    assert torch.equal(finals[False].momentum, finals[True].momentum)


# ---------------------------------------------------------- thresholds
def _run(task, byz, f=F, steps=120, lr=0.1, seed=0):
    """tests/test_sim.py's ``_run``: the port with its own draws."""
    X, Y, Xt, Yt = task
    wx, wy = worker_datasets(X, Y, n_good=N - f, n_byz=f, noniid=True, seed=seed)
    sim = ByzantineSim(loss_fn=nll_loss, byz=byz, n_workers=N, n_byzantine=f, lr=lr,
                       batch_size=32, device="cpu")
    Xt, Yt = torch.tensor(Xt), torch.tensor(Yt)
    _, hist = sim.run(init_mlp(torch.Generator().manual_seed(1 + seed), device="cpu"),
                      torch.tensor(wx), torch.tensor(wy), steps,
                      torch.Generator().manual_seed(2 + seed),
                      eval_fn=lambda p: accuracy(p, Xt, Yt), eval_every=steps)
    assert hist["step"] == [steps] and len(hist["zeta_sq"]) == 1
    return hist["eval"][-1]


def test_mean_learns_noniid_no_attack(task):
    acc = _run(task, ByzConfig(aggregator="mean", attack="none"), f=0)
    assert acc > 0.75, acc


def test_krum_fails_noniid_bucketing_fixes(task):
    vanilla = _run(task, ByzConfig(aggregator="krum", mixing="none", attack="none",
                                   n_byzantine=0), f=0)
    mixed = _run(task, ByzConfig(aggregator="krum", mixing="bucketing", s=2, attack="none",
                                 n_byzantine=0), f=0)
    assert mixed > vanilla + 0.05, (vanilla, mixed)


def _run_on_reference_draws(task, kw, f=F, steps=120, seed=0):
    """tests/test_sim.py's ``_run`` with the reference's whole run handed
    to the port: its start (``init_mlp(PRNGKey(1 + seed))``) and every
    step's draws from ``PRNGKey(2 + seed)``, split as its ``run`` splits
    (drawn in one compiled scan: the same values as step by step)."""
    X, Y, Xt, Yt = task
    wx, wy = worker_datasets(X, Y, n_good=N - f, n_byz=f, noniid=True, seed=seed)
    sim = ByzantineSim(loss_fn=nll_loss, byz=ByzConfig(**kw), n_workers=N, n_byzantine=f,
                       lr=0.1, batch_size=32, device="cpu")
    ragg = RByzConfig(**kw).make_aggregator(N)

    def draw(key, _):
        key, sub = jax.random.split(key)
        k_batch, _, k_agg = jax.random.split(sub, 3)
        idx = jax.random.randint(k_batch, (N, 32), 0, wx.shape[1])
        return key, (idx, ragg.mixing_matrix(k_agg, N))

    _, (idx, mix) = jax.jit(lambda k: jax.lax.scan(draw, k, None, length=steps))(
        jax.random.PRNGKey(2 + seed))
    params = {k: np.asarray(v) for k, v in rinit_mlp(jax.random.PRNGKey(1 + seed)).items()}
    state = sim.init_state(params_from_jax(params, device="cpu"))
    twx, twy = torch.tensor(wx), torch.tensor(wy)
    for t in range(steps):
        state, _ = sim.step(state, twx, twy, Draws(torch.tensor(np.asarray(idx[t]), dtype=torch.long),
                                                   torch.tensor(np.asarray(mix[t]))))
    return float(accuracy(state.params, torch.tensor(Xt), torch.tensor(Yt)))


def test_mimic_hurts_cm_bucketing_helps(task):
    """At n = 10 this gate sits inside the spread of the draws: over the
    seeds 0-4 of ``_run`` the reference's bucketed CM misses it at seeds 2
    and 4 and the port's own draws at 0 and 4. So the port runs it on the
    reference's draws, on which the reference passes."""
    plain = _run_on_reference_draws(task, dict(aggregator="cm", mixing="none",
                                               attack="mimic", n_byzantine=F))
    mixed = _run_on_reference_draws(task, dict(aggregator="cm", mixing="bucketing", s=2,
                                               attack="mimic", n_byzantine=F))
    assert mixed > plain - 0.07, (plain, mixed)
    assert mixed > 0.5, mixed


def test_cclip_robust_to_ipm(task):
    byz = ByzConfig(aggregator="cclip", mixing="bucketing", s=2, worker_momentum=0.9,
                    attack="ipm", attack_kwargs=(("eps", 0.1),), n_byzantine=F)
    acc = _run(task, byz, lr=0.5)
    assert acc > 0.6, acc


def test_bitflip_defended_by_rfa(task):
    acc = _run(task, ByzConfig(aggregator="rfa", mixing="bucketing", s=2, attack="bitflip",
                               n_byzantine=F))
    assert acc > 0.6, acc


def test_sim_metrics_finite(workers):
    wx, wy = workers
    byz = ByzConfig(aggregator="rfa", mixing="bucketing", s=2, attack="alie",
                    attack_kwargs=(("n", N), ("f", F)), n_byzantine=F)
    sim = ByzantineSim(loss_fn=nll_loss, byz=byz, lr=0.05, batch_size=16, n_workers=N,
                       n_byzantine=F, device="cpu")
    state = sim.init_state(init_mlp(torch.Generator().manual_seed(3), device="cpu"))
    state, metrics = sim.step(state, torch.tensor(wx), torch.tensor(wy),
                              sim.draw(torch.Generator().manual_seed(4), wx.shape[1]))
    assert sorted(metrics) == ["agg_norm", "grad_norm_mean", "zeta_sq"]
    for v in metrics.values():
        assert bool(torch.isfinite(v))


def test_the_sim_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ByzantineSim(loss_fn=nll_loss, byz=ByzConfig(), **SIM)


# ------------------------------------------------------------ pipeline
def test_sample_worker_batches_match_reference():
    rng = np.random.default_rng(0)
    data_x = rng.standard_normal((4, 20, 3)).astype(np.float32)
    data_y = rng.integers(0, 10, (4, 20)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    idx = jax.random.randint(key, (4, 5), 0, 20)  # the reference sampler's draw
    rbx, rby = rsample_worker_batches(key, jnp.asarray(data_x), jnp.asarray(data_y), 5)
    bx, by = sample_worker_batches(torch.tensor(np.asarray(idx), dtype=torch.long),
                                   torch.tensor(data_x), torch.tensor(data_y))
    np.testing.assert_array_equal(bx.numpy(), np.asarray(rbx))
    np.testing.assert_array_equal(by.numpy(), np.asarray(rby))
    seqs = rng.integers(0, 100, (3, 8, 6)).astype(np.int32)
    tidx = jax.random.randint(key, (3, 4), 0, 8)
    want = rsample_token_batches(key, jnp.asarray(seqs), 4)
    got = sample_token_batches(torch.tensor(np.asarray(tidx), dtype=torch.long),
                               torch.tensor(seqs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_batch_idx():
    idx = draw_batch_idx(torch.Generator().manual_seed(0), 6, 13, 32)
    assert idx.shape == (6, 32) and idx.dtype == torch.long
    assert int(idx.min()) >= 0 and int(idx.max()) < 13
    again = draw_batch_idx(torch.Generator().manual_seed(0), 6, 13, 32, device="cpu")
    assert torch.equal(idx, again)


# -------------------------------------------------------------- config
def test_paper_config_matches_reference():
    cfg, rcfg = configs.get_config("paper-mnist-mlp"), rget_config("paper-mnist-mlp")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert "paper-mnist-mlp" not in configs.list_archs()
    assert configs.list_archs(include_paper=True)[-1] == "paper-mnist-mlp"


# -------------------------------------------------------------- theory
def test_variance_estimators_match_reference():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((9, 13)).astype(np.float32)
    for fn in ("pairwise_variance", "heterogeneity_zeta_sq"):
        want = float(getattr(rtheory, fn)(jnp.asarray(xs)))
        got = float(getattr(theory, fn)(torch.tensor(xs)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=fn)
    same = torch.tensor(xs[0]).expand(5, 13)
    assert float(theory.heterogeneity_zeta_sq(same)) < 1e-10


@pytest.mark.parametrize("n,delta,zeta,mu", [(10, 0.2, 1.0, 1.0), (20, 0.1, 1.0, 1.0),
                                             (10, 0.2, 2.0, 0.5)])
def test_lower_bound_instance_matches_reference(n, delta, zeta, mu):
    inst = theory.LowerBoundInstance(n=n, delta=delta, zeta=zeta, mu=mu)
    ref = rtheory.LowerBoundInstance(n=n, delta=delta, zeta=zeta, mu=mu)
    assert inst.n_byz == ref.n_byz and inst.G == ref.G
    x = 0.7
    for i in range(n):
        np.testing.assert_allclose(float(inst.worker_grad(i, torch.tensor(x))),
                                   float(ref.worker_grad(i, jnp.asarray(x))), rtol=1e-6)
    for w in (1, 2):
        assert inst.optimum(w) == ref.optimum(w)
        np.testing.assert_allclose(float(inst.objective(w, torch.tensor(x))),
                                   float(ref.objective(w, jnp.asarray(x))), rtol=1e-6)
    assert inst.suboptimality_floor() == ref.suboptimality_floor()
    x_star, err = inst.best_achievable_max_error()
    rx, rerr = ref.best_achievable_max_error()
    assert x_star == rx
    np.testing.assert_allclose(err, rerr, rtol=1e-6)
    np.testing.assert_allclose(err, inst.suboptimality_floor() / 2, rtol=1e-6)


@pytest.mark.parametrize("c,delta,B_sq", [(1.0, 0.0, 100.0), (1.0, 0.1, 3.0), (10.0, 0.1, 1.0),
                                          (1.0, 0.2, 5 / 3)])
def test_overparam_gate_matches_reference(c, delta, B_sq):
    assert theory.overparam_bound_ok(c, delta, B_sq) == rtheory.overparam_bound_ok(c, delta, B_sq)


def test_label_flip_matches_reference():
    y = np.arange(10, dtype=np.int32)
    np.testing.assert_array_equal(label_flip_targets(torch.tensor(y)).numpy(),
                                  np.asarray(rlabel_flip_targets(jnp.asarray(y))))
    assert label_flip_targets(torch.tensor([0, 4, 9])).tolist() == [9, 5, 0]
