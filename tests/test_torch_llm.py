"""The port's LLM stack (every family) held against the JAX reference on
the CPU.

Configs, layers, both attention impls, the ring-buffer decode cache, and
forward / loss (with the MoE router losses) / decode / prefill of every
architecture at its ``smoke_config`` size (dense, MoE, SSM, the hybrid,
the VLM with prefix embeddings, the audio model with codebooks), with the
reference's parameters carried across by ``convert.params_from_jax``.
Everything runs in fp32. Tolerances: the reference's own where it has one
(2e-4 for attention, tests/test_attention.py; 2e-3 for decode against
forward, 5e-3 for the SSM family's, tests/test_models.py); 1e-4 for logits
of the two packages on the same parameters (fp32 sums in other orders
through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.distributed.steps import make_prefill_step as r_make_prefill_step
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.distributed.steps import make_prefill_step
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServeEngine
from repro_torch.utils.tree import tree_flatten

ARCHS = ["gemma-7b", "internvl2-2b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "mamba2-130m",
         "musicgen-medium", "olmoe-1b-7b", "qwen1.5-32b", "qwen2.5-14b", "tinyllama-1.1b"]
#: the SSM family's decode against its forward: the reference's bar
#: (tests/test_models.py::test_decode_matches_forward_ssm)
SSM_DECODE_TOL = 5e-3


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _carry(rparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")


# ------------------------------------------------------------------ configs
def test_ported_configs_equal_the_reference():
    assert configs.list_archs() == ARCHS
    for arch in ARCHS:
        for get in ("get_config", "smoke_config"):
            mine = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(rconfigs, get)(arch))
            assert mine == theirs, (arch, get)
        cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
        assert (cfg.head_dim_, cfg.pattern_, cfg.period, cfg.n_periods, cfg.param_count()) == \
            (rcfg.head_dim_, rcfg.pattern_, rcfg.period, rcfg.n_periods, rcfg.param_count())
        if cfg.family in ("ssm", "hybrid"):
            assert (cfg.d_inner, cfg.ssm_heads) == (rcfg.d_inner, rcfg.ssm_heads)
    assert configs.get_config("olmoe-1b-7b").param_count() == 6_919_096_320
    assert configs.get_config("mamba2-130m").param_count() == 128_958_336
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("mamba3-130m")
    with pytest.raises(KeyError):
        rconfigs.get_config("mamba3-130m")


# ------------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match():
    x = _rand((2, 12, 4, 64), seed=1, scale=3.0)
    scale = _rand((64,), seed=2)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5).numpy(),
        _np(rlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)),
        rtol=1e-5, atol=1e-6)
    for positions in (np.arange(12), np.arange(24).reshape(2, 12) * 7):
        np.testing.assert_allclose(
            layers.apply_rope(_t(x), _t(positions), 10000.0).numpy(),
            _np(rlayers.apply_rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)),
            rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_block_matches(kind):
    rp = rlayers.init_mlp_block(jax.random.PRNGKey(3), 64, 96, kind, jnp.float32)
    x = _rand((2, 5, 64), seed=4)
    np.testing.assert_allclose(layers.mlp_block(_carry(rp), _t(x), kind).numpy(),
                               _np(rlayers.mlp_block(rp, jnp.asarray(x), kind)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- attention
def _attn_setup(seed=0, B=2, S=64, **kw):
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), **kw)
    rcfg = dataclasses.replace(rconfigs.smoke_config("tinyllama-1.1b"), **kw)
    rp = rattn.init_attention(jax.random.PRNGKey(seed), rcfg)
    x = _rand((B, S, cfg.d_model), seed=seed + 1)
    return cfg, rcfg, rp, _carry(rp), x


# the cases of tests/test_attention.py: windowed and ragged (S = 72, blocks 24)
@pytest.mark.parametrize("window,S", [(0, 64), (32, 64), (0, 96), (32, 96), (0, 72)])
@pytest.mark.parametrize("impl", ["xla", "blockwise"])
def test_attention_matches(impl, window, S):
    cfg, rcfg, rp, tp, x = _attn_setup(sliding_window=window, attn_block_q=32,
                                       attn_block_kv=32, S=S)
    positions = np.arange(S)[None, :]
    got = attn.attention(tp, _t(x), cfg, _t(positions), impl=impl)
    want = rattn.attention(rp, jnp.asarray(x), rcfg, jnp.asarray(positions), impl=impl)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)
    other = attn.attention(tp, _t(x), cfg, _t(positions),
                           impl="xla" if impl == "blockwise" else "blockwise")
    np.testing.assert_allclose(got.numpy(), other.numpy(), rtol=2e-4, atol=2e-4)


def test_attention_helpers_match():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(attn._expand_kv(_t(k), 6).numpy(),
                                  _np(rattn._expand_kv(jnp.asarray(k), 6)))
    for S, target in [(4096, 512), (4352, 512), (33024, 1024), (7, 512), (72, 32)]:
        assert attn._divisor_block(S, target) == rattn._divisor_block(S, target)
    cfg, _, _, tp, x = _attn_setup()
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.attention(tp, _t(x), cfg, torch.arange(64)[None], impl="flash")


@pytest.mark.parametrize("window,L,S", [(0, 12, 12), (8, 8, 20)])
def test_decode_ring_buffer_matches(window, L, S):
    """A full-length cache, and a ring of capacity = window, reproduce the
    full-sequence attention (the reference's bars: 2e-4 full, 5e-4 ring);
    each step equals the reference's decode step."""
    cfg, rcfg, rp, tp, x = _attn_setup(seed=5, B=1, S=S, sliding_window=window)
    full = attn.attention(tp, _t(x), cfg, torch.arange(S)[None], impl="xla")
    cache = attn.init_kv_cache(1, L, cfg, torch.float32, "cpu")
    rcache = rattn.init_kv_cache(1, L, rcfg, jnp.float32)
    tol = 2e-4 if window == 0 else 5e-4
    for t in range(S):
        old, k_before = cache, cache["k"].clone()
        out, cache = attn.decode_attention(tp, _t(x[:, t:t + 1]), cache, cfg, t)
        assert torch.equal(old["k"], k_before)  # the cache passed in is left as it was
        rout, rcache = rattn.decode_attention(rp, jnp.asarray(x[:, t:t + 1]), rcache, rcfg,
                                              jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(out.numpy(), _np(rout), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cache["k"].numpy(), _np(rcache["k"]), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- models
def _model(arch, **kw):
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), **kw)
    cfg = dataclasses.replace(configs.smoke_config(arch), **kw)
    rp = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    if rcfg.qkv_bias:  # the reference inits biases at zero: make them count
        for i, name in enumerate(("bq", "bk", "bv")):
            leaf = rp["blocks"]["0"]["mixer"][name]
            rp["blocks"]["0"]["mixer"][name] = jnp.asarray(_rand(leaf.shape, seed=10 + i))
    return cfg, rcfg, rp, _carry(rp)


def _inputs(cfg, B, S, seed):
    """Tokens ([B, S], or [B, K, S] for codebooks) and, for a config with
    prefix tokens, ``prefix_embeds`` [B, n_prefix, D]; numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    toks = rng.integers(0, cfg.vocab_size, shape)
    prefix = (_rand((B, cfg.n_prefix_tokens, cfg.d_model), seed=seed + 1)
              if cfg.n_prefix_tokens else None)
    return toks, prefix


@pytest.mark.parametrize("arch,kw", [(a, {}) for a in ARCHS]
                         + [("tinyllama-1.1b", {"logit_softcap": 30.0})])
def test_forward_loss_and_prefill_match(arch, kw):
    cfg, rcfg, rp, tp = _model(arch, **kw)
    toks, prefix = _inputs(cfg, 2, 32, seed=6)
    labels = toks.copy()
    labels[0, ..., :5] = -100
    pe = None if prefix is None else _t(prefix)
    rpe = None if prefix is None else jnp.asarray(prefix)
    logits, aux = tfm.forward(tp, cfg, _t(toks), prefix_embeds=pe)
    rlogits, _ = rtfm.forward(rp, rcfg, jnp.asarray(toks), prefix_embeds=rpe)
    tail = (cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else (cfg.vocab_size,)
    assert logits.shape == (2, 32) + tail and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(rlogits), rtol=1e-4, atol=1e-4)
    batch = {"tokens": toks, "labels": labels}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    loss, aux = tfm.loss_fn(tp, cfg, {k: _t(v) for k, v in batch.items()})
    rloss, raux = rtfm.loss_fn(rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert float(aux["ce_loss"]) == float(loss) and sorted(aux) == sorted(raux)
    for last_only in (True, False):
        got = make_prefill_step(cfg, last_only=last_only, device="cpu")(tp, batch)
        want = r_make_prefill_step(rcfg, None, last_only=last_only)(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_and_reference(arch):
    """Token-by-token decode reproduces the teacher-forced forward logits
    (the reference's bars: 2e-3, 5e-3 for an SSM mixer) and the reference's
    decode step (1e-4); codebook tokens go in as [B, K]."""
    cfg, rcfg, rp, tp = _model(arch)
    B, S = 1, 8
    toks, _ = _inputs(cfg, B, S, seed=7)
    full, _ = tfm.forward(tp, cfg, _t(toks))
    cache = tfm.init_cache(cfg, B, S, device="cpu")
    rcache = rtfm.init_cache(rcfg, B, S)
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in tree_flatten(cache)[0]] == \
        [(x.shape, x.dtype.name) for x in jax.tree_util.tree_leaves(rcache)]
    tol = SSM_DECODE_TOL if any(m == "ssm" for m, _ in cfg.pattern_) else 2e-3
    for t in range(S):
        logits, cache = tfm.decode_step(tp, cfg, cache, _t(toks[..., t]), t)
        rlogits, rcache = rtfm.decode_step(rp, rcfg, rcache, jnp.asarray(toks[..., t]),
                                           jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(logits.numpy(), _np(rlogits), rtol=1e-4, atol=1e-4)
    for got, want in zip(tree_flatten(cache)[0], jax.tree_util.tree_leaves(rcache)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


def test_decode_matches_forward_ssm():
    """tests/test_models.py's case through the port: Mamba2's recurrent
    decode equals its chunked-scan forward over 16 tokens (one chunk of
    the smoke config), the reference's bar 5e-3."""
    cfg, _, _, tp = _model("mamba2-130m")
    B, S = 1, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    full, _ = tfm.forward(tp, cfg, _t(toks))
    cache = tfm.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        step, cache = tfm.decode_step(tp, cfg, cache, _t(toks[:, t]), t)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(), rtol=SSM_DECODE_TOL,
                                   atol=SSM_DECODE_TOL)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], prefix + (k,)).items()}
    return {prefix: tuple(tree.shape)}


def test_param_tree_maps_one_to_one():
    """Every arch's tree has the reference's paths, shapes and dtypes. Its
    size is the reference tree's; the reference's ``param_count`` formula
    equals it except for an SSM mixer, where the formula counts a
    ``norm2`` that an ``("ssm", "none")`` layer lacks and leaves out
    ``dt_bias`` and ``conv_b``: the port copies the formula as it is."""
    for arch in ARCHS:
        rcfg, cfg = rconfigs.smoke_config(arch), configs.smoke_config(arch)
        mine = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        theirs = jax.eval_shape(lambda: rtfm.init_params(rcfg, jax.random.PRNGKey(0)))
        assert _paths(mine) == _paths(theirs)
        assert [str(x.dtype).split(".")[-1] for x in tree_flatten(mine)[0]] == \
            [x.dtype.name for x in jax.tree_util.tree_leaves(theirs)]
        n = sum(x.numel() for x in tree_flatten(mine)[0])
        assert n == sum(x.size for x in jax.tree_util.tree_leaves(theirs))
        assert cfg.param_count() == rcfg.param_count()
        if not any(m == "ssm" for m, _ in cfg.pattern_):
            assert n == cfg.param_count()


def test_bf16_tree_round_trip_is_bit_exact():
    """A bf16 reference tree carries across bit for bit, for the dense
    model and each family this needs another tree for; fp32 leaves (the
    SSM's ``A_log``, ``D``, ``dt_bias``, a MoE layer's router) stay fp32,
    bit for bit."""
    for arch in ("tinyllama-1.1b", "mamba2-130m", "jamba-v0.1-52b", "internvl2-2b",
                 "musicgen-medium", "qwen1.5-32b"):
        rcfg = dataclasses.replace(rconfigs.smoke_config(arch), dtype="bfloat16")
        rp = jax.tree_util.tree_map(np.asarray, rtfm.init_params(rcfg, jax.random.PRNGKey(0)))
        tp = params_from_jax(rp, device="cpu")
        f32 = set()
        for (path, a), t in zip(jax.tree_util.tree_leaves_with_path(rp), tree_flatten(tp)[0]):
            if a.dtype == np.float32:
                f32.add(path[-1].key)
                assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
                continue
            assert a.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
            bits = a.view(np.uint16)
            back = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, bits)  # torch -> numpy gives the same bits
            via_f32 = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
            assert torch.equal(via_f32.view(torch.int16), t.view(torch.int16))
        want = {"A_log", "D", "dt_bias"} if rcfg.family in ("ssm", "hybrid") else set()
        assert f32 == want | ({"router"} if rcfg.n_experts else set()), arch


def test_unported_paths_raise():
    """The prefill takes a mesh (``tests/test_torch_sharding.py``), but not
    an object that is none; the engine refuses codebooks, as the
    reference's does."""
    cfg, _, _, tp = _model("tinyllama-1.1b")
    with pytest.raises(TypeError, match="ProcessGroup"):
        make_prefill_step(cfg, mesh=object(), device="cpu")
    mcfg, _, _, mp = _model("musicgen-medium")
    with pytest.raises(NotImplementedError, match="plain-LM"):
        ServeEngine(mcfg, mp, device="cpu")
