"""``remat="full"``: the training forward recomputes each period in the
backward (``transformer.forward_hidden``), as the reference wraps its
period body in ``jax.checkpoint``.

Held on the CPU at smoke width:
- the port against itself: loss, aux and every gradient bit for bit
  between ``remat="full"`` and ``"none"`` for every family (dense, MoE,
  SSM, hybrid, prefix embeddings, codebooks), and each period run twice;
- the port against the reference with ``remat="full"`` (its
  ``jax.checkpoint``) at ``tests/test_torch_train.py``'s gradient bar, rtol
  1e-4 / atol 1e-5;
- ``make_train_step``: two steps of RFA with worker momentum and of CM bit
  for bit between the settings, and one against the reference's step with
  remat at ``test_train_step_matches_reference``'s bar (rtol 1e-4 / atol
  1e-6); one fsdp step over 2 gloo ranks bit for bit;
- the serving prefill and ``decode_step``, which autograd does not record:
  the same logits and the same ATen ops under both settings;
- the MoE layer's dropped assignments, which the recompute replays: the
  same count as the reference's on the same parameters and inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_shard_ranks
from repro import configs as rconfigs
from repro.configs.base import ByzConfig as RByzConfig
from repro.models import moe as rmoe
from repro.models import transformer as rtfm
from repro.models.layers import rmsnorm as r_rmsnorm
from repro_torch import configs
from repro_torch.analysis import op_trace
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import opt_state_from_jax, params_from_jax, worker_m_from_jax
from repro_torch.distributed.steps import make_prefill_step, make_train_step
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import tree_flatten, tree_unflatten
from test_torch_train import (LR_STEP, W, _grads_both, _leaves_np, _np, _opt_start,
                              _reference_step, _step_start)

#: one config a family: dense, MoE, SSM, hybrid, VLM (prefix), audio (codebooks)
FAMILIES = ["gemma-7b", "olmoe-1b-7b", "mamba2-130m", "jamba-v0.1-52b", "internvl2-2b",
            "musicgen-medium"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, remat, **kw):
    return dataclasses.replace(configs.smoke_config(arch), remat=remat, **kw)


def _batch(cfg, B=2, S=32, seed=2):
    """Tokens and labels ([B, K, S] for codebooks, -100 among the labels),
    and prefix embeddings for a config with prefix tokens."""
    g = torch.Generator().manual_seed(seed)
    lead = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    toks = torch.randint(0, cfg.vocab_size, lead + (S + 1,), generator=g)
    labels = toks[..., 1:].clone()
    labels[..., :3] = -100
    batch = {"tokens": toks[..., :-1], "labels": labels}
    if cfg.n_prefix_tokens:
        batch["prefix_embeds"] = (torch.randn((B, cfg.n_prefix_tokens, cfg.d_model), generator=g)
                                  * 0.5).to(getattr(torch, cfg.dtype))
    return batch


def _loss_and_grads(params, cfg, batch, monkeypatch):
    """``loss_fn``'s loss, aux and the gradient of every leaf, and how many
    times ``rmsnorm`` ran (backward included) and a checkpoint was entered."""
    calls = {"rmsnorm": 0, "checkpoint": 0}
    saved = {name: getattr(tfm, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return call

    for name in calls:
        monkeypatch.setattr(tfm, name, counted(name))
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, aux = tfm.loss_fn(tree_unflatten(treedef, live), cfg, batch)
    grads = torch.autograd.grad(loss, live)
    for name, fn in saved.items():
        monkeypatch.setattr(tfm, name, fn)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads, calls


@pytest.mark.parametrize("arch,dtype,impl", [(a, "float32", "xla") for a in FAMILIES]
                         + [("gemma-7b", "float32", "blockwise"),
                            ("gemma-7b", "bfloat16", "xla"),
                            ("kimi-k2-1t-a32b", "float32", "xla")])
def test_remat_changes_no_bit(arch, dtype, impl, monkeypatch):
    """Loss, every aux value (the MoE layers' losses and drop fraction) and
    every gradient equal bit for bit with and without recompute; with it,
    each period is one checkpoint and every norm inside the periods runs
    twice (the forward, then the recompute in the backward), the final
    norm once."""
    runs = {}
    for remat in ("none", "full"):
        cfg = _cfg(arch, remat, dtype=dtype, attention_impl=impl, attn_block_q=16,
                   attn_block_kv=16)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        runs[remat] = _loss_and_grads(params, cfg, _batch(cfg), monkeypatch)
    (loss, aux, grads, n_none), (rloss, raux, rgrads, n_full) = runs["none"], runs["full"]
    assert torch.equal(loss, rloss) and torch.isfinite(loss)
    assert aux.keys() == raux.keys() and all(torch.equal(aux[k], raux[k]) for k in aux)
    assert len(grads) == len(rgrads)
    for g, rg in zip(grads, rgrads):
        assert g.dtype == rg.dtype and torch.equal(g, rg)
    assert n_full["rmsnorm"] == 2 * n_none["rmsnorm"] - 1
    assert (n_none["checkpoint"], n_full["checkpoint"]) == (0, cfg.n_periods)


@pytest.mark.parametrize("arch", ["gemma-7b", "jamba-v0.1-52b", "olmoe-1b-7b"])
def test_remat_matches_reference_checkpoint(arch):
    """The port with recompute against ``jax.grad`` through the reference's
    ``jax.checkpoint(period_body)``, every leaf in fp32 (the bar of
    ``test_loss_fn_gradients_fp32``)."""
    (loss, grads), (rloss, rgrads) = _grads_both(arch, remat="full")
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert len(grads) == len(rgrads)
    for g, rg in zip(grads, rgrads):
        assert g.shape == rg.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(rg), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ train steps
def _steps(arch, agg, remat, mixes):
    """``make_train_step`` steps (worker momentum 0.9, sgdm), one a mix, from
    ``_step_start``'s state: the parameters, optimizer state, worker
    momenta and losses after them."""
    cfg = dataclasses.replace(configs.smoke_config(arch), momentum_mode="worker", remat=remat)
    byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9)
    step_fn, _ = make_train_step(cfg, byz, lr=LR_STEP, optimizer="sgdm", n_workers=W,
                                 device="cpu")
    params, batch, worker_m, m, v = _step_start(arch)
    params = params_from_jax(params, device="cpu")
    opt_state = opt_state_from_jax(_opt_start("sgdm", m, v), device="cpu")
    worker_m = worker_m_from_jax(worker_m, device="cpu")
    batch = {k: torch.tensor(x) for k, x in batch.items()}
    losses = []
    for mix in mixes:
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m,
                                                       torch.tensor(mix), batch)
        losses.append(metrics["loss"])
    return dict(params=params, opt_state=opt_state, worker_m=worker_m, losses=losses)


def _mixes(agg, seeds):
    aggregator = RByzConfig(aggregator=agg, mixing="bucketing", s=2).make_aggregator(W)
    return [np.asarray(aggregator.mixing_matrix(jax.random.PRNGKey(k), W)) for k in seeds]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_train_steps_keep_their_bits_under_remat(arch, agg):
    """Two steps with recompute leave the parameters, the optimizer state,
    the worker momenta and the losses bit for bit as without it."""
    mixes = _mixes(agg, (7, 8))
    plain, remat = (tree_flatten(_steps(arch, agg, r, mixes))[0] for r in ("none", "full"))
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_train_step_with_remat_matches_reference(arch, agg):
    """One step with recompute in both packages (the reference's worker
    gradients through ``jax.checkpoint``), assembled as
    ``test_train_step_matches_reference`` assembles it: the loss, the
    parameters' update, the optimizer momentum and the worker momenta
    within rtol 1e-4 / atol 1e-6."""
    rparams, ropt, rwm, rloss, mix = _reference_step(agg, "bucketing", "worker", "sgdm", 0.9,
                                                     jax.random.PRNGKey(5), arch, remat="full")
    got = _steps(arch, agg, "full", [mix])
    close = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(got["losses"][0]), float(rloss), **close)
    p0 = _leaves_np(_step_start(arch)[0])
    for a, b, p in zip(tree_flatten(got["params"])[0], _leaves_np(rparams), p0):
        np.testing.assert_allclose(_np(a).astype(np.float64) - p, b.astype(np.float64) - p,
                                   **close)
    for mine, theirs in ((got["opt_state"].m, ropt.m), (got["worker_m"], rwm)):
        g, w = tree_flatten(mine)[0], _leaves_np(theirs)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(_np(a), b, **close)
    assert int(got["opt_state"].step) == int(ropt.step) == 4


def test_fsdp_step_over_two_ranks_keeps_its_bits():
    """gemma-7b at smoke width, fsdp on a 2-rank gloo group (data=2), one
    RFA step with server momentum: each rank's gathered parameters, its
    optimizer momentum and the loss are the same bits with and without
    recompute."""
    ranks = spawn_ranks(torch_shard_ranks.fsdp_remat_step, 2, backend="gloo",
                        devices=["cpu", "cpu"], args=({"arch": "gemma-7b", "W": 2},),
                        timeout_s=300)
    for r in ranks:
        assert r["fsdp"] and r["remat"] == ("none", "full")
        plain, remat = r["runs"]
        assert len(plain) == len(remat) > 0
        for a, b in zip(plain, remat):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ranks[0]["runs"][0], ranks[1]["runs"][0]):
        assert np.array_equal(a, b)  # the gathered state is the same on both ranks


# ----------------------------------------------------------------- serving
class _Sequence(TorchDispatchMode):
    """The ATen ops a call dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _recorded(fn, monkeypatch):
    """``fn()``'s result, its ATen op counts (``op_trace.trace``), its op
    sequence and the checkpoints it entered."""
    entered = []
    checkpoint = tfm.checkpoint
    monkeypatch.setattr(tfm, "checkpoint", lambda *a, **kw: entered.append(1)
                        or checkpoint(*a, **kw))
    seq = _Sequence()
    with seq:
        out, t = op_trace.trace(fn)
    monkeypatch.setattr(tfm, "checkpoint", checkpoint)
    return out, t.op_counts, seq.ops, len(entered)


@pytest.mark.parametrize("grad", [False, True], ids=["grad_off", "grad_on"])
@pytest.mark.parametrize("arch", ["gemma-7b", "jamba-v0.1-52b", "musicgen-medium"])
def test_prefill_and_decode_run_the_same_ops(arch, grad, monkeypatch):
    """The serving prefill and ``decode_step``, with grad disabled and with
    grad enabled on parameters that require none (as the engine runs
    them): the same logits bit for bit and the same ATen ops in the same
    order under both settings; no checkpoint is entered."""
    got = {}
    for remat in ("none", "full"):
        cfg = _cfg(remat=remat, arch=arch)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = _batch(cfg, B=2, S=16)
        tokens = batch["tokens"]
        cache = tfm.init_cache(cfg, 2, 32, device="cpu")
        with torch.set_grad_enabled(grad):
            prefill = _recorded(lambda: make_prefill_step(cfg, device="cpu")(
                params, {k: v for k, v in batch.items() if k != "labels"}), monkeypatch)
            decode = _recorded(lambda: tfm.decode_step(params, cfg, cache, tokens[..., 0], 0),
                               monkeypatch)
        got[remat] = (prefill, decode)
    for (out, counts, seq, n), (rout, rcounts, rseq, rn) in zip(got["none"], got["full"]):
        logits, rlogits = (o[0] if isinstance(o, tuple) else o for o in (out, rout))
        assert torch.equal(logits, rlogits) and torch.isfinite(logits).all()
        assert counts == rcounts and seq == rseq and len(seq) > 0
        assert n == rn == 0


# ------------------------------------------------------------------- MoE
def test_moe_drops_equal_the_references():
    """OLMoE at smoke width in bf16 on 2 x 64 tokens, the capacity factor at
    1.0 so that an expert above the mean load drops: the MoE input is the
    first layer's (embedding, attention, norm, the reference's functions on
    its parameters), and both packages' layers give each expert the same
    load and drop the same number of assignments (> 0)."""
    arch = "olmoe-1b-7b"
    kw = dict(dtype="bfloat16", capacity_factor=1.0)
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), **kw)
    cfg = dataclasses.replace(configs.smoke_config(arch), **kw)
    rp = rtfm.init_params(rcfg, jax.random.PRNGKey(3))
    lp = jax.tree_util.tree_map(lambda x: x[0], rp["blocks"]["0"])
    toks = jnp.asarray(np.random.default_rng(4).integers(0, rcfg.vocab_size, (2, 64)))
    h = rtfm.embed_tokens(rp, rcfg, toks)
    h = h + rtfm.attn_mod.attention(lp["mixer"], r_rmsnorm(lp["norm1"], h, rcfg.norm_eps),
                                    rcfg, jnp.arange(64)[None, :])
    x = r_rmsnorm(lp["norm2"], h, rcfg.norm_eps)
    _, raux = rmoe.moe_layer(lp["ff"], x, rcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, lp["ff"]), device="cpu")
    tx = params_from_jax(np.asarray(x), device="cpu")
    _, aux = moe.moe_layer(tp, tx, cfg)
    T, K, E = 2 * 64, cfg.experts_per_token, cfg.n_experts
    dropped = round(float(aux["moe_drop_frac"]) * T * K)
    assert dropped == round(float(raux["moe_drop_frac"]) * T * K) > 0
    # each expert's load from each package's own routing
    gates = jax.nn.softmax(x.reshape(T, -1).astype(jnp.float32) @ lp["ff"]["router"], axis=-1)
    rload = np.bincount(np.asarray(jax.lax.top_k(gates, K)[1]).ravel(), minlength=E)
    tgates = torch.softmax(tx.reshape(T, -1).float() @ tp["router"], dim=-1)
    load = torch.bincount(torch.sort(tgates, dim=-1, descending=True, stable=True)[1][:, :K]
                          .reshape(-1), minlength=E).numpy()
    np.testing.assert_array_equal(load, rload)
    C = moe.expert_capacity(T, cfg)
    assert int(np.maximum(load - C, 0).sum()) == dropped
