"""The port's MoE layer held against the JAX reference on the CPU.

The same numpy inputs (from a seed) go through ``repro.models.moe`` and
``repro_torch.models.moe``; the reference's parameters are carried across
by ``convert.params_from_jax``. Tolerances: fp32 outputs at rtol / atol
1e-5 (the two packages sum the expert products and the K gated terms in
other orders), the drop fraction exactly, the load-balance and z losses at
1e-6; bf16 at 2e-2 (each op rounds to bf16); the gradient of
``sum(out^2)`` at 1e-4 against ``jax.grad``; the port against a torch copy
of ``tests/test_moe.py``'s dense oracle at that test's 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.layers import mlp_block
from repro_torch.utils.tree import tree_flatten

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="olmoe-1b-7b", **kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(configs.smoke_config(arch), **kw),
            dataclasses.replace(rconfigs.smoke_config(arch), **kw))


def _params(rcfg, seed=0):
    rp = jax.tree_util.tree_map(np.asarray, rmoe.init_moe(jax.random.PRNGKey(seed), rcfg))
    return rp, params_from_jax(rp, device="cpu")


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    x = x.detach()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _both(cfg, rcfg, rp, tp, x):
    out, aux = moe.moe_layer(tp, torch.tensor(x).to(getattr(torch, cfg.dtype)), cfg)
    rout, raux = rmoe.moe_layer(jax.tree_util.tree_map(jnp.asarray, rp),
                                jnp.asarray(x).astype(rcfg.dtype), rcfg)
    return (out, aux), (rout, raux)


def _assert_aux(aux, raux):
    assert set(aux) == set(raux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in aux.values())
    assert float(aux["moe_drop_frac"]) == float(raux["moe_drop_frac"])
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,S", [(8.0, 8), (0.1, 64), (1.25, 32)],
                         ids=["no-drops", "drops", "default"])
def test_moe_layer_matches_reference_fp32(arch, capacity_factor, S):
    cfg, rcfg = _cfgs(arch, capacity_factor=capacity_factor)
    rp, tp = _params(rcfg)
    x = _x((2, S, cfg.d_model), scale=0.5)
    (out, aux), (rout, raux) = _both(cfg, rcfg, rp, tp, x)
    assert out.shape == (2, S, cfg.d_model) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(rout), rtol=1e-5, atol=1e-5)
    _assert_aux(aux, raux)
    if capacity_factor == 8.0:
        assert float(aux["moe_drop_frac"]) == 0.0
    if capacity_factor == 0.1:
        assert 0.0 < float(aux["moe_drop_frac"]) < 1.0


def test_collapsed_router_picks_the_references_experts():
    """tests/test_moe.py's collapsed router (8 experts, top-3): experts 1-7
    tie exactly in every token, and the port picks the lower indices among
    them, as ``jax.lax.top_k`` does."""
    cfg, rcfg = _cfgs(n_experts=8, experts_per_token=3)
    rp, _ = _params(rcfg)
    rp = dict(rp)
    router = np.zeros_like(rp["router"])
    router[:, 0] = 10.0
    rp["router"] = router
    tp = params_from_jax(rp, device="cpu")
    x = _x((2, 32, cfg.d_model))
    logits = torch.tensor(x).reshape(-1, cfg.d_model) @ tp["router"]
    gates = torch.softmax(logits, dim=-1)
    _, ridx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), axis=-1), 3)
    picked = torch.sort(gates, dim=-1, descending=True, stable=True).indices[:, :3]
    assert np.array_equal(picked.numpy(), np.asarray(ridx))
    for row in np.asarray(ridx):
        tied = [e for e in row if e != 0]
        assert tied == list(range(1, len(tied) + 1)), row
    (out, aux), (rout, raux) = _both(cfg, rcfg, rp, tp, x)
    np.testing.assert_allclose(_np(out), np.asarray(rout), rtol=1e-5, atol=1e-5)
    _assert_aux(aux, raux)
    assert float(aux["moe_lb_loss"]) > 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference_bf16(arch):
    cfg, rcfg = _cfgs(arch, dtype="bfloat16", capacity_factor=1.25)
    rp, tp = _params(rcfg)
    assert tp["w_up"].dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    x = _x((2, 32, cfg.d_model), scale=0.5)
    (out, aux), (rout, raux) = _both(cfg, rcfg, rp, tp, x)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(rout, np.float32), rtol=2e-2, atol=2e-2)
    assert float(aux["moe_drop_frac"]) == float(raux["moe_drop_frac"])
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches(arch):
    for cf in (0.1, 1.25, 8.0):
        cfg, rcfg = _cfgs(arch, capacity_factor=cf)
        for T in (1, 4, 8, 9, 64, 100, 1024, 8192):
            assert moe.expert_capacity(T, cfg) == rmoe.expert_capacity(T, rcfg), (cf, T)
    full = configs.get_config("olmoe-1b-7b")
    assert moe.expert_capacity(8192, full) == 1280  # a 2 x 4096 prefill
    assert all(moe.expert_capacity(T, full) >= T for T in range(1, 9))  # decode drops nothing


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches(arch):
    cfg, rcfg = _cfgs(arch)
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = jax.eval_shape(lambda: rmoe.init_moe(jax.random.PRNGKey(0), rcfg))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, theirs)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, mine))
    for a, b in zip(tree_flatten(mine)[0], jax.tree_util.tree_leaves(theirs)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == b.dtype.name


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["no-drops", "drops"])
def test_moe_gradients_match_jax_grad(capacity_factor):
    """The gradient of ``sum(out^2)`` in every parameter and in x."""
    cfg, rcfg = _cfgs("kimi-k2-1t-a32b", capacity_factor=capacity_factor)
    rp, tp = _params(rcfg)
    x = _x((2, 32, cfg.d_model), scale=0.5)

    def rloss(p, xx):
        out, _ = rmoe.moe_layer(p, xx, rcfg)
        return jnp.sum(out ** 2)

    rg, rgx = jax.grad(rloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, rp),
                                              jnp.asarray(x))
    leaves, _ = tree_flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out, _ = moe.moe_layer(tp, tx, cfg)
    grads = torch.autograd.grad(torch.sum(out ** 2), leaves + [tx])
    want = jax.tree_util.tree_leaves(rg) + [rgx]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)


def naive_moe(p, x, cfg):
    """tests/test_moe.py's dense oracle in torch: every token through every
    expert, gated by the renormalised top-k softmax (no capacity limit)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    gates = torch.softmax(xt @ p["router"], dim=-1)
    topg, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topg, topi = topg[:, :cfg.experts_per_token], topi[:, :cfg.experts_per_token]
    topg = topg / topg.sum(-1, keepdim=True)
    outs = []
    for e in range(cfg.n_experts):
        if "w_gate" in p:
            act = F.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
        else:
            act = F.gelu(xt @ p["w_up"][e], approximate="tanh")
        outs.append(act @ p["w_down"][e])
    outs = torch.stack(outs, dim=1)  # [T, E, D]
    mask = torch.zeros((xt.shape[0], cfg.n_experts)).scatter(1, topi, topg)
    out = torch.einsum("te,ted->td", mask, outs)
    for i in range(cfg.n_shared_experts):
        out = out + mlp_block(p[f"shared_{i}"], xt, cfg.mlp_kind)
    return out.reshape(B, S, D)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_oracle_no_drops(arch):
    cfg, _ = _cfgs(arch, capacity_factor=8.0)
    tp = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.tensor(_x((2, 8, cfg.d_model), seed=2, scale=0.5))
    out, aux = moe.moe_layer(tp, x, cfg)
    assert float(aux["moe_drop_frac"]) == 0.0
    np.testing.assert_allclose(_np(out), _np(naive_moe(tp, x, cfg)), rtol=2e-3, atol=2e-3)


def test_moe_layer_repeats_bitwise_and_grads_reach_every_expert():
    """Two calls give the same bits; with 64 tokens over 4 experts every
    expert gets tokens and a non-zero gradient (tests/test_moe.py)."""
    cfg, _ = _cfgs(capacity_factor=8.0)
    tp = moe.init_moe(torch.Generator().manual_seed(3), cfg, device="cpu")
    x = torch.tensor(_x((2, 32, cfg.d_model), seed=4))
    a, b = moe.moe_layer(tp, x, cfg)[0], moe.moe_layer(tp, x, cfg)[0]
    assert torch.equal(a, b)
    w_up = tp["w_up"].requires_grad_(True)
    out, _ = moe.moe_layer(tp, x, cfg)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [w_up])
    assert bool((g.reshape(cfg.n_experts, -1).norm(dim=1) > 0).all())
