"""The CNN of App. Table 5 (``models/mlp.py::init_cnn / cnn_apply /
cnn_nll_loss``) held against the reference's, and through both simulators.

Same numpy inputs from a seed go through both packages, the reference's
parameters carried across by ``convert.params_from_jax``. Tolerances: the
forward within rtol 1e-5 / atol 1e-6 (the reference kernels' own for the
mix; measured ~1e-7 here), loss and gradients within rtol 1e-4 with atol
1e-7 (gradient entries near zero, measured ~5e-7 of a leaf's largest), the
simulators' parameters and momenta within rtol 1e-4 / atol 1e-6 as
tests/test_torch_byzantine.py and tests/test_torch_cross_device.py hold the
MLP's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.func import grad, vmap

from repro.configs.base import ByzConfig as RByzConfig
from repro.core.momentum import init_worker_momentum as rinit_worker_momentum
from repro.data.partition import worker_datasets
from repro.data.synthetic import make_train_test
from repro.distributed import shard_kernels as rshard_kernels
from repro.kernels.flash_attention import NEG_INF as RNEG_INF
from repro.models import mlp as R
from repro.training.byzantine import ByzantineSim as RByzantineSim
from repro.training.cross_device import CrossDeviceSim as RCrossDeviceSim
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.momentum import init_worker_momentum
from repro_torch.distributed import shard_kernels
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models import mlp as T
from repro_torch.training import byzantine as tbyz
from repro_torch.training import cross_device as tcd

#: the App. A.2.3 knob and the parameter count at each scale
SCALES = {1: 52_114, 2: 206_874, 4: 824_362}
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-7)
SIM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and torch's default of one thread a core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(scale, seed=1):
    return {k: np.asarray(v) for k, v in R.init_cnn(jax.random.PRNGKey(seed), scale).items()}


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, 784), dtype=np.float32), rng.integers(0, 10, n)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("scale", sorted(SCALES))
def test_shapes_and_names_are_the_references(scale):
    ref = _ref_params(scale)
    port = T.init_cnn(torch.Generator().manual_seed(0), scale, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in port.values())
    assert sum(v.numel() for v in port.values()) == SCALES[scale]
    # the reference's scales: 0.1 for the convs, 1/sqrt(fan_in) for the FCs
    for name, want in (("conv2", 0.1), ("fc1", (16 * scale * 49) ** -0.5)):
        assert abs(float(port[name].std()) / want - 1) < 0.05, name
    assert not port["b1"].any() and not port["b2"].any()


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_params_from_jax_carries_the_cnn_over(scale):
    ref = _ref_params(scale)
    port = params_from_jax(ref, device="cpu")
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        assert port[k].dtype == torch.float32 and np.array_equal(port[k].numpy(), v), k
    # the flattened layout (sorted keys) is the reference's, leaf for leaf
    flat = tbyz.stack_flatten_workers({k: v[None] for k, v in port.items()})[0]
    rflat = np.concatenate([ref[k].reshape(-1) for k in sorted(ref)])
    assert np.array_equal(flat.numpy(), rflat)


@pytest.mark.parametrize("scale", [1, 2])
def test_forward_matches_reference(scale):
    ref = _ref_params(scale)
    x, _ = _batch(16)
    want = np.asarray(R.cnn_apply({k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(x)))
    got = T.cnn_apply(params_from_jax(ref, device="cpu"), torch.tensor(x)).numpy()
    assert got.shape == (16, 10)
    np.testing.assert_allclose(got, want, **FWD)


def test_loss_and_gradient_match_jax_grad():
    ref = _ref_params(1)
    x, y = _batch(16, seed=1)
    rl, rg = jax.value_and_grad(R.cnn_nll_loss)({k: jnp.asarray(v) for k, v in ref.items()},
                                                jnp.asarray(x), jnp.asarray(y))
    live = {k: v.requires_grad_() for k, v in params_from_jax(ref, device="cpu").items()}
    loss = T.cnn_nll_loss(live, torch.tensor(x), torch.tensor(y))
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-4)
    for (k, _), g in zip(live.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg[k]), **GRAD, err_msg=k)


def test_per_worker_gradients_under_vmap_match_the_references():
    """``vmap(grad(...), in_dims=(None, 0, 0))``, as both simulators take
    per-worker gradients: conv2d and max_pool2d batched, forward and back."""
    ref = _ref_params(1)
    rng = np.random.default_rng(2)
    xs = rng.random((5, 8, 784), dtype=np.float32)
    ys = rng.integers(0, 10, (5, 8))
    rg = jax.vmap(jax.grad(R.cnn_nll_loss), in_axes=(None, 0, 0))(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(xs), jnp.asarray(ys))
    tg = vmap(grad(T.cnn_nll_loss), in_dims=(None, 0, 0))(
        params_from_jax(ref, device="cpu"), torch.tensor(xs), torch.tensor(ys))
    for k in ref:
        assert tuple(tg[k].shape) == (5,) + ref[k].shape
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(rg[k]), **GRAD, err_msg=k)


def test_pool_tie_routes_the_gradient_as_jax_does():
    """An exact tie of two positive values in one 2 x 2 pool window: both
    libraries send the window's gradient to its first maximum. conv1 is the
    identity (a centred delta in every channel), so the tie reaches the pool
    exactly and the input gradient shows where the pool routed it."""
    ref = _ref_params(1)
    ref["conv1"] = np.zeros_like(ref["conv1"])
    ref["conv1"][1, 1, 0, :] = 1.0
    x = np.full((1, 784), 0.1, dtype=np.float32)
    x[0, 0] = x[0, 1] = 0.5          # window (0, 0): a tie in row 0
    x[0, 28 * 2 + 3] = x[0, 28 * 3 + 2] = 0.7   # window (1, 1): a tie across rows
    y = np.array([3])
    rgx = np.asarray(jax.grad(R.cnn_nll_loss, argnums=1)(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(x), jnp.asarray(y)))
    xt = torch.tensor(x, requires_grad=True)
    T.cnn_nll_loss(params_from_jax(ref, device="cpu"), xt, torch.tensor(y)).backward()
    tgx = xt.grad.numpy()
    for g in (rgx, tgx):
        assert g[0, 0] != 0 and g[0, 1] == 0 and g[0, 28] == 0 and g[0, 29] == 0
        assert g[0, 28 * 2 + 3] != 0 and g[0, 28 * 3 + 2] == 0
    np.testing.assert_allclose(tgx, rgx, **GRAD)


def test_flatten_order_is_nhwc():
    """fc1's rows run (h, w, c): the same rows permuted to NCHW order give
    the reference's logits only through an NCHW flatten, and break the
    port's."""
    ref = _ref_params(1)
    x, _ = _batch(8, seed=3)
    want = np.asarray(R.cnn_apply({k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(x)))
    C = ref["conv2"].shape[-1]
    nchw_rows = np.array([(h * 7 + w) * C + c for c in range(C) for h in range(7)
                          for w in range(7)])
    permuted = params_from_jax(dict(ref, fc1=ref["fc1"][nchw_rows]), device="cpu")
    broken = T.cnn_apply(permuted, torch.tensor(x)).numpy()
    assert np.abs(broken - want).max() > 100 * FWD["atol"]
    # the permutation is right: an NCHW flatten with those rows is the reference
    h = torch.tensor(x).reshape(8, 1, 28, 28)
    for name in ("conv1", "conv2"):
        h = torch.nn.functional.conv2d(h, permuted[name].permute(3, 2, 0, 1), padding=1)
        h = torch.nn.functional.max_pool2d(torch.relu(h), 2, 2)
    h = torch.relu(h.reshape(8, -1) @ permuted["fc1"] + permuted["b1"])
    np.testing.assert_allclose((h @ permuted["fc2"] + permuted["b2"]).numpy(), want, **FWD)


# --------------------------------------------------------- the simulators
class _Probe(torch.autograd.Function):
    """Identity that records the TF32 flags in its forward and backward."""

    seen = []
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        _Probe.seen.append(("forward", torch.backends.cudnn.allow_tf32,
                            torch.backends.cuda.matmul.allow_tf32))
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _Probe.seen.append(("backward", torch.backends.cudnn.allow_tf32,
                            torch.backends.cuda.matmul.allow_tf32))
        return g


def _probed_loss(params, x, y):
    return T.cnn_nll_loss(dict(params, conv1=_Probe.apply(params["conv1"])), x, y)


@pytest.mark.parametrize("sim", ["byzantine", "cross_device"])
def test_sims_take_gradients_in_ieee_fp32(sim):
    """cuDNN convolves in TF32 by default: both simulators take the
    per-worker gradients, forward and backward, with TF32 off, and give the
    caller's flags back."""
    params = T.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    byz = ByzConfig(aggregator="cm", mixing="bucketing", s=2, attack="none")
    if sim == "byzantine":
        s = tbyz.ByzantineSim(loss_fn=_probed_loss, byz=byz, n_workers=4, n_byzantine=0,
                              batch_size=4, device="cpu")
        wx = torch.tensor(rng.random((4, 16, 784), dtype=np.float32))
        wy = torch.tensor(rng.integers(0, 10, (4, 16)))
        draws = s.draw(torch.Generator().manual_seed(0), 16)
    else:
        s = tcd.CrossDeviceSim(loss_fn=_probed_loss, byz=byz, n_clients=6, byz_frac=0.0,
                               clients_per_round=4, batch_size=4, device="cpu")
        wx = torch.tensor(rng.random((6, 16, 784), dtype=np.float32))
        wy = torch.tensor(rng.integers(0, 10, (6, 16)))
        draws = s.draw(torch.Generator().manual_seed(0), 16)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    _Probe.seen.clear()
    try:
        s.step(s.init_state(params), wx, wy, draws)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert sorted({p for p, _, _ in _Probe.seen}) == ["backward", "forward"]
    assert all(not cudnn and not matmul for _, cudnn, matmul in _Probe.seen)


@pytest.fixture(scope="module")
def task():
    X, Y, _, _ = make_train_test(jax.random.PRNGKey(0), n_train=1000, n_test=100)
    return np.asarray(X), np.asarray(Y)


def _byz(cls, agg, n_byzantine):
    return cls(aggregator=agg, mixing="bucketing", s=2, attack="bitflip",
               n_byzantine=n_byzantine)


@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_byzantine_sim_lockstep_with_the_reference(task, agg):
    """Three ``ByzantineSim`` steps with the CNN from the same start through
    the reference's draws (n = 6, f = 1)."""
    n, f = 6, 1
    wx, wy = (np.asarray(a) for a in worker_datasets(*task, n_good=n - f, n_byz=f,
                                                     noniid=True))
    kw = dict(n_workers=n, n_byzantine=f, lr=0.1, batch_size=8)
    rsim = RByzantineSim(loss_fn=R.cnn_nll_loss, byz=_byz(RByzConfig, agg, f), **kw)
    tsim = tbyz.ByzantineSim(loss_fn=T.cnn_nll_loss, byz=_byz(ByzConfig, agg, f),
                             device="cpu", **kw)
    ref = _ref_params(1)
    rstate = rsim.init_state({k: jnp.asarray(v) for k, v in ref.items()})
    tstate = tsim.init_state(params_from_jax(ref, device="cpu"))
    for t in range(3):
        key = jax.random.PRNGKey(100 + t)
        k_batch, _, k_agg = jax.random.split(key, 3)
        idx = jax.random.randint(k_batch, (n, 8), 0, wx.shape[1])
        draws = tbyz.Draws(torch.tensor(np.asarray(idx), dtype=torch.long),
                           torch.tensor(np.asarray(rsim.aggregator.mixing_matrix(k_agg, n))))
        rstate, _ = rsim.step(rstate, jnp.asarray(wx), jnp.asarray(wy), key)
        tstate, _ = tsim.step(tstate, torch.tensor(wx), torch.tensor(wy), draws)
    for k, v in rstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v), **SIM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tstate.momentum.numpy(), np.asarray(rstate.momentum), **SIM_TOL)


@pytest.mark.parametrize("agg", ["rfa", "cm", "tm"])
def test_cross_device_sim_lockstep_with_the_reference(task, agg):
    """Two ``CrossDeviceSim`` rounds with the CNN through the packed engine,
    from the same start through the reference's draws."""
    wx, wy = (np.asarray(a) for a in worker_datasets(*task, n_good=9, n_byz=1, noniid=True))
    kw = dict(n_clients=10, byz_frac=0.1, clients_per_round=6, lr=0.5, batch_size=8,
              server_momentum=0.9)
    rsim = RCrossDeviceSim(loss_fn=R.cnn_nll_loss, byz=_byz(RByzConfig, agg, 0), **kw)
    tsim = tcd.CrossDeviceSim(loss_fn=T.cnn_nll_loss, byz=_byz(ByzConfig, agg, 0),
                              device="cpu", **kw)
    ref = _ref_params(1)
    rstate = rsim.init_state({k: jnp.asarray(v) for k, v in ref.items()})
    tstate = tsim.init_state(params_from_jax(ref, device="cpu"))
    for t in range(2):
        key = jax.random.PRNGKey(200 + t)
        k_sample, k_batch, _, k_agg = jax.random.split(key, 4)
        draws = tcd.Draws(
            torch.tensor(np.asarray(jax.random.randint(k_sample, (6,), 0, 10)),
                         dtype=torch.long),
            torch.tensor(np.asarray(jax.random.randint(k_batch, (6, 8), 0, wx.shape[1])),
                         dtype=torch.long),
            torch.tensor(np.asarray(rsim.aggregator.mixing_matrix(k_agg, 6))))
        rstate, _ = rsim.step(rstate, jnp.asarray(wx), jnp.asarray(wy), key)
        tstate, _ = tsim.step(tstate, torch.tensor(wx), torch.tensor(wy), draws)
    for k, v in rstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v), **SIM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tstate.server_m.numpy(), np.asarray(rstate.server_m), **SIM_TOL)


# ------------------------------------------------------ the small names
def test_init_worker_momentum_and_neg_inf_are_the_references():
    g0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert init_worker_momentum(torch.tensor(g0)).numpy().tolist() == np.asarray(
        rinit_worker_momentum(jnp.asarray(g0))).tolist()
    tree = {"a": torch.ones(2)}
    assert init_worker_momentum(tree) is tree
    assert NEG_INF == RNEG_INF


@pytest.mark.parametrize("axes", [("data",), ("data", "model"), ("pod", "data", "model")])
def test_col_and_vec_specs_are_the_references(axes, monkeypatch):
    mesh = types.SimpleNamespace(axis_names=axes)
    monkeypatch.setattr(shard_kernels, "as_mesh", lambda m: m)
    assert shard_kernels.col_spec(mesh) == tuple(rshard_kernels.col_spec(mesh))
    assert shard_kernels.vec_spec(mesh) == tuple(rshard_kernels.vec_spec(mesh))
    assert rshard_kernels.col_spec(mesh) == P(*shard_kernels.col_spec(mesh))
