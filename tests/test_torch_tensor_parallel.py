"""Compute along the model axis (``models/parallel.py``,
``distributed/sharding.py::compute_shardings``, the train step and the
block ingress ``packing.pack_from_shardings``) held against the reference.

4 gloo ranks on the CPU are started once for the module and lay out the
meshes (1, 4) and (2, 2) in turn (``torch_shard_ranks.tensor_parallel``,
which imports no jax). Each rank runs ``loss_fn`` on its compute blocks of
the same parameters (numpy, carried by ``convert.params_from_jax``), and the
gradients, gathered whole, are held against the reference's
``jax.value_and_grad(loss_fn)`` on the same parameters and batch, and
against the port's one-device ``loss_fn``, at
``tests/test_torch_train.py``'s bars (rtol 1e-4, atol 1e-5).
"""

import concurrent.futures
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from repro import configs as rconfigs
from repro.core.aragg import RobustAggregator as RRobustAggregator
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import compute_shardings
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.parallel import model_split
from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_map

#: label -> (arch, config fields); every family and every branch of the plan
CASES = {
    "gemma": ("gemma-7b", {}),
    "tinyllama_kv2": ("tinyllama-1.1b", {"n_kv_heads": 2, "logit_softcap": 30.0}),
    "whole_attention": ("qwen2.5-14b", {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64}),
    "olmoe": ("olmoe-1b-7b", {}),
    "mamba2": ("mamba2-130m", {}),
    "musicgen": ("musicgen-medium", {}),
    "gemma_remat": ("gemma-7b", {"remat": "full"}),
    # MoE along the model axis: a shared expert beside the experts (fsdp),
    # an SSM layer whole beside split experts, 6 experts (split on (2, 2),
    # whole on (1, 4)), and a capacity that drops assignments
    "kimi": ("kimi-k2-1t-a32b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "olmoe_e6": ("olmoe-1b-7b", {"n_experts": 6}),
    "olmoe_drops": ("olmoe-1b-7b", {"capacity_factor": 0.5}),
    # SSM heads along the model axis: 6 heads, split on (2, 2), whole on (1, 4);
    # split heads in a period recomputed in the backward
    "mamba2_h6": ("mamba2-130m", {"d_model": 192, "ssm_head_dim": 64}),
    "mamba2_remat": ("mamba2-130m", {"remat": "full"}),
    # attention whose heads T does not divide: 6 heads over t = 2 head blocks
    # on (1, 4), each held by 2 ranks, kv heads split; whole k / v in a period
    # recomputed in the backward; a plain split on (2, 2)
    "qwen_h6": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 2}),
    "qwen_h6_kv1_remat": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 1, "remat": "full"}),
}
MOE_CASES = [label for label, (arch, _) in CASES.items()
             if arch in ("olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")]
#: label -> (arch, config fields) of the MoE and SSM train steps on the
#: mesh: worker momentum and its momenta in expert blocks (OLMoE, one
#: layer), fsdp and a shared expert with server momentum (Kimi K2; its
#: optimizer momentum in fp32, since a bf16 one turns a last-bit difference
#: of a gradient into a whole bf16 step), the hybrid's period (Jamba),
#: worker momenta in an SSM layer's segmented head blocks (Mamba2, one
#: layer), and worker momenta in attention head blocks held by 2 replicas
#: each on (1, 4) (the 6-head qwen, fsdp, one layer)
MOE_STEPS = {"olmoe": ("olmoe-1b-7b", {"n_layers": 1}),
             "kimi": ("kimi-k2-1t-a32b", {"n_layers": 1, "opt_m_dtype": "float32"}),
             "jamba": ("jamba-v0.1-52b", {}),
             "mamba2": ("mamba2-130m", {"n_layers": 1}),
             "qwen_h6": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 2, "n_layers": 1,
                                         "momentum_mode": "worker"})}
#: the block ingress's plans (arch -> config fields): dense blocks, Mamba2's
#: segmented SSM leaves, and replicated attention blocks (6 heads: t = 2 on
#: (1, 4))
INGRESS = {"gemma-7b": {}, "mamba2-130m": {}, "qwen2.5-14b": {"n_heads": 6, "n_kv_heads": 2}}
MESHES = [(1, 4), (2, 2)]
B, S, W = 2, 16, 4
RTOL, ATOL = 1e-4, 1e-5


def _batch(cfg, seed):
    """Next-token tokens and labels ([B, K, S] for codebooks, -100 among
    them) and, for a config with prefix tokens, ``prefix_embeds``."""
    rng = np.random.default_rng(seed)
    lead = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    toks = rng.integers(0, cfg.vocab_size, lead + (S + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :3] = -100
    batch = {"tokens": toks[..., :-1], "labels": labels}
    if cfg.n_prefix_tokens:
        batch["prefix_embeds"] = (rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model))
                                  * 0.5).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _case(label):
    """``(cfg, reference cfg, parameters as numpy, batch)``: the port's
    init drawn from a seed, a tree of the reference's structure (the
    packages' trees match: ``tests/test_torch_sharding.py``)."""
    arch, fields = CASES[label]
    cfg = dataclasses.replace(configs.smoke_config(arch), **fields)
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), **fields)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    return cfg, rcfg, tree_map(lambda t: t.numpy(), params), _batch(cfg, seed=2)


@functools.lru_cache(maxsize=None)
def _reference(label):
    """The reference's loss and gradient leaves, and the port's one-device
    loss, gradients and embedded stream, on the case's parameters; then
    the port's one-device routing of each MoE layer (``(idx_topk, keep)``)
    and both packages' ``moe_drop_frac`` (``None`` without MoE)."""
    cfg, rcfg, rp, batch = _case(label)
    (rloss, raux), rg = jax.jit(jax.value_and_grad(rtfm.loss_fn, has_aux=True),
                                static_argnums=1)(rp, rcfg, {k: jnp.asarray(v)
                                                             for k, v in batch.items()})
    params = params_from_jax(rp, device="cpu")
    leaves, _ = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with moe.recorded_routes() as routes:
        loss, aux = tfm.loss_fn(params, cfg, tb)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        h = tfm.embed_tokens(params, cfg, tb["tokens"])
    drops = (None, None) if "moe_drop_frac" not in aux else (
        aux["moe_drop_frac"].detach().numpy(), np.asarray(raux["moe_drop_frac"]))
    return (float(rloss), [np.asarray(g) for g in jax.tree_util.tree_leaves(rg)],
            float(loss.detach()), [g.numpy() for g in grads], h.numpy(), routes, drops)


def _steps_payload():
    cfg = configs.smoke_config("gemma-7b")
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (2 * W, 17))
    ra = RRobustAggregator.from_spec("rfa", mixing="bucketing", s=2)
    qtoks = np.random.default_rng(22).integers(0, 512, (2 * W, 17))
    return {"W": W, "batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, "moe": MOE_STEPS,
            "qwen_batch": {"tokens": qtoks[:, :-1], "labels": qtoks[:, 1:]},
            "mix": np.asarray(ra.mixing_matrix(jax.random.PRNGKey(30), W))}


@pytest.fixture(scope="module")
def group():
    """Every rank's results of ``tensor_parallel``: one group runs both
    meshes. While the ranks run, this process computes the references the
    tests read (cached; one that raises is left for its test to raise)."""
    payload = {"meshes": MESHES,
               "cases": {label: {"arch": CASES[label][0], "cfg": CASES[label][1],
                                 "params": _case(label)[2], "batch": _case(label)[3]}
                         for label in CASES},
               "ingress": INGRESS, "steps": _steps_payload()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, torch_shard_ranks.tensor_parallel, 4, backend="gloo",
                            devices=["cpu"] * 4, args=(payload,), timeout_s=900)
        for warm, keys in ((_reference, CASES), (_one_device_step, ["worker", "server"]
                                                 + list(MOE_STEPS))):
            for key in keys:
                with contextlib.suppress(Exception):
                    warm(key)
        return payload, ranks.result()


@pytest.fixture(params=MESHES, ids=["1x4", "2x2"])
def tp_ranks(request, group):
    """Every rank's results on one mesh, and the (4, 1) mesh's against the
    bare group."""
    payload, ranks = group
    return request.param, payload, [dict(r[tuple(request.param)],
                                         one_model_rank=r["one_model_rank"]) for r in ranks]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


class _Mesh:
    """What ``compute_shardings`` reads of a mesh: ``shape`` and
    ``axis_names``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


@pytest.mark.parametrize("label", list(CASES))
def test_loss_and_gradients_on_compute_blocks(tp_ranks, label):
    """The loss and every gradient, from each rank's compute blocks and
    gathered whole, against the reference's ``jax.value_and_grad`` and the
    port's one-device ``loss_fn`` (rtol 1e-4, atol 1e-5); the loss and the
    gathered gradients are the same bits on every rank (a leaf held whole
    gets the same gradient on every model rank)."""
    _, _, ranks = tp_ranks
    rloss, rgrads, loss1, grads1 = _reference(label)[:4]
    out = ranks[0]["cases"][label]
    np.testing.assert_allclose(float(out["loss"]), rloss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(out["loss"]), loss1, rtol=RTOL, atol=ATOL)
    assert len(out["grads"]) == len(rgrads) == len(grads1)
    for g, rg, g1 in zip(out["grads"], rgrads, grads1):
        assert g.shape == rg.shape == g1.shape
        np.testing.assert_allclose(g, rg, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, g1, rtol=RTOL, atol=ATOL)
    for r in ranks[1:]:
        assert _same_bits(r["cases"][label]["loss"], out["loss"])
        assert all(_same_bits(a, b) for a, b in zip(r["cases"][label]["grads"], out["grads"]))


def _block_width(n: int, entry, T: int) -> int:
    """A dim of ``n`` under a compute-plan entry: cut by T where it is
    ``"model"``, by t where it is the replicated-block ``("model", t)``;
    for segments, each split one cut by T, each whole one kept."""
    if isinstance(entry, tuple) and isinstance(entry[-1], int):
        assert entry[0] == "model" and T % entry[1] == 0 and entry[1] < T
        return n // entry[1]
    if isinstance(entry, tuple):
        assert sum(size for size, _ in entry) == n
        return sum(size // T if e == "model" else size for size, e in entry)
    return n // T if entry == "model" else n


def test_compute_blocks_follow_the_plan(tp_ranks):
    """Each rank's gradients have its compute blocks' shapes: the split
    dims cut by T, a segmented dim's split segments cut by T and its whole
    ones kept, every other dim whole; the plan's flags are
    ``model_split``'s (whole k / v for tinyllama's 2 kv heads at T = 4,
    whole attention for 3 heads, everything split for gemma, SSM heads
    split where T divides them: Mamba2's 16 and Jamba's 16, the 6 of
    ``mamba2_h6`` on (2, 2) only; the 6 q heads of ``qwen_h6`` in t = 2
    head blocks on both meshes, each block held by T / t ranks, its 2 kv
    heads split, its 1 kv head whole in ``qwen_h6_kv1_remat``). An SSM
    layer's in_proj block is z, x and dt of the rank's heads beside whole
    B and C, its conv's the x channels beside whole B and C. Where t < T
    the replicas of a head block hold the same block of wq / wk / wv / wo,
    those of different blocks different ones."""
    (_, T), _, ranks = tp_ranks
    keys = ("attn", "kv", "mlp", "vocab", "moe", "moe_shared", "ssm", "t")
    want_flags = {"gemma": (True, True, True, True, False, False, False, T),
                  "tinyllama_kv2": (True, T == 2, True, True, False, False, False, T),
                  "whole_attention": (False, False, True, True, False, False, False, 1),
                  "olmoe": (True, True, True, True, True, True, False, T),
                  "kimi": (True, True, True, True, True, True, False, T),
                  "jamba": (True, True, True, True, True, True, True, T),
                  "olmoe_e6": (True, True, True, True, T == 2, T == 2, False, T),
                  "mamba2": (False, False, True, True, False, False, True, 1),
                  "mamba2_remat": (False, False, True, True, False, False, True, 1),
                  "mamba2_h6": (False, False, True, True, False, False, T == 2, 1),
                  "qwen_h6": (True, True, True, True, False, False, False, 2),
                  "qwen_h6_kv1_remat": (True, False, True, True, False, False, False, 2)}
    for label in CASES:
        cfg = _case(label)[0]
        plan = compute_shardings(cfg, tfm.params_shape(cfg), _Mesh(data=4 // T, model=T))
        flags = model_split(cfg, T)
        if label in want_flags:
            assert tuple(flags[k] for k in keys) == want_flags[label], label
        for r, out in enumerate(ranks):
            case = out["cases"][label]
            assert case["split"] == flags
            specs = [(path, pl.spec) for path, pl in tree_flatten_with_path(plan)[0]]
            for (path, spec), shape, whole in zip(specs, case["local"], case["grads"]):
                assert shape == tuple(_block_width(n, e, T) for n, e in zip(whole.shape, spec))
                if path.endswith("mixer/in_proj") and flags["ssm"]:
                    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
                    assert shape[-1] == (2 * din + h) // T + 2 * n, label
                if path.endswith("mixer/conv_w") and flags["ssm"]:
                    assert shape[1] == cfg.d_inner // T + 2 * cfg.ssm_state, label
                if path.endswith("mixer/wq") and flags["attn"]:
                    assert shape[-1] == cfg.n_heads * cfg.head_dim_ // flags["t"], label
        if flags["attn"]:  # each rank its head block g = m // (T / t) of the whole
            whole = dict(tree_flatten_with_path(_case(label)[2])[0])
            for out in ranks:
                g = out["coords"]["model"] // (T // flags["t"])
                for path, block in out["cases"][label]["attn_blocks"].items():
                    name, w = path.split("/")[-1], np.asarray(block).shape
                    if name == "wo":
                        want = whole[path][:, g * w[1]:(g + 1) * w[1]]
                    elif name in ("wq", "bq") or flags["kv"]:
                        want = whole[path][..., g * w[-1]:(g + 1) * w[-1]]
                    else:  # whole k / v
                        want = whole[path]
                    assert _same_bits(block, want), (label, path)


def test_plan_on_the_production_mesh():
    """The plan at full width on (16, 16), spec for spec, where the storage
    rules put the model axis on input dims: gemma's heads, kv heads, d_ff
    and vocab split (wq / wk / wv / w_gate / w_up on their output dim, wo /
    w_down on their rows, the tied embed on its rows); qwen2.5-14b's 40
    heads and 8 kv heads in 8 head blocks of 5 and 1, each held by 2 model
    ranks (``("model", 8)`` on wq / wk / wv / bq / bk / bv's output dim and
    wo's rows), its MLP and vocab split; qwen1.5-32b's 40 / 40 heads and
    musicgen-medium's 24 / 24 in 8 blocks too (5 / 5 and 3 / 3 a block);
    tinyllama's 4 kv heads whole beside 32 split q heads; with T = 1 every
    leaf whole."""
    mesh = _Mesh(data=16, model=16)
    eight = ("model", 8)
    want = {
        "gemma-7b": {"embed": ("model", None), "blocks/0/mixer/wq": (None, None, "model"),
                     "blocks/0/mixer/wk": (None, None, "model"),
                     "blocks/0/mixer/wo": (None, "model", None),
                     "blocks/0/ff/w_gate": (None, None, "model"),
                     "blocks/0/ff/w_down": (None, "model", None),
                     "blocks/0/norm1/scale": (None, None)},
        "qwen2.5-14b": {"blocks/0/mixer/wq": (None, None, eight),
                        "blocks/0/mixer/wk": (None, None, eight),
                        "blocks/0/mixer/wv": (None, None, eight),
                        "blocks/0/mixer/wo": (None, eight, None),
                        "blocks/0/mixer/bq": (None, eight), "blocks/0/mixer/bk": (None, eight),
                        "blocks/0/ff/w_up": (None, None, "model"),
                        "embed": ("model", None), "lm_head": (None, "model")},
        "qwen1.5-32b": {"blocks/0/mixer/wq": (None, None, eight),
                        "blocks/0/mixer/wv": (None, None, eight),
                        "blocks/0/mixer/wo": (None, eight, None),
                        "blocks/0/mixer/bv": (None, eight)},
        "musicgen-medium": {"blocks/0/mixer/wq": (None, None, eight),
                            "blocks/0/mixer/wk": (None, None, eight),
                            "blocks/0/mixer/wo": (None, eight, None),
                            "blocks/0/ff/w_down": (None, "model", None),
                            "lm_head": (None, None, "model")},
        "tinyllama-1.1b": {"blocks/0/mixer/wq": (None, None, "model"),
                           "blocks/0/mixer/wk": (None, None, None),
                           "blocks/0/mixer/wo": (None, "model", None)},
    }
    blocks = {"qwen2.5-14b": (5, 1), "qwen1.5-32b": (5, 5), "musicgen-medium": (3, 3)}
    for arch, specs in want.items():
        cfg = configs.get_config(arch)
        shapes = tfm.params_shape(cfg)
        plan = compute_shardings(cfg, shapes, mesh)
        got = {p: pl.spec for p, pl in tree_flatten_with_path(plan)[0]}
        for path, spec in specs.items():
            assert got[path] == spec, (arch, path)
        assert all(set(s) <= {None, "model", eight} for s in got.values())
        if arch in blocks:  # a rank's block: 5 / 1, 5 / 5 or 3 / 3 heads of 128 / 64
            flags = model_split(cfg, 16)
            assert flags["t"] == 8 and flags["attn"] and flags["kv"]
            mixer = {k: v for k, v in tree_flatten_with_path(shapes)[0]}
            local = {p: pl.local_shape(mixer[p].shape) for p, pl in
                     tree_flatten_with_path(plan)[0] if "/mixer/w" in p}
            dh = cfg.head_dim_
            assert local["blocks/0/mixer/wq"][-1] == blocks[arch][0] * dh
            assert local["blocks/0/mixer/wk"][-1] == blocks[arch][1] * dh
            assert local["blocks/0/mixer/wo"][1] == blocks[arch][0] * dh
        one = compute_shardings(cfg, shapes, _Mesh(data=16, model=1))
        assert all(not any(pl.spec) for pl in tree_flatten(one)[0])


def test_plan_puts_experts_on_the_model_axis():
    """MoE at full width on (16, 16) (depth cut to 2 layers, one period for
    Jamba, to build the shapes quickly): the three stacked expert leaves
    split on their expert dim (dim 1 after the period dim), Kimi K2's shared
    expert as the MLP (columns of w_gate / w_up, rows of w_down), the fp32
    router whole, Jamba's SSM layers split by heads beside its split
    experts; on a
    model axis of 5, which divides none of the expert counts, every expert
    leaf whole; with T = 1 every leaf whole."""
    experts = {"blocks/{i}/ff/w_gate": (None, "model", None, None),
               "blocks/{i}/ff/w_up": (None, "model", None, None),
               "blocks/{i}/ff/w_down": (None, "model", None, None),
               "blocks/{i}/ff/router": (None, None, None)}
    for arch, layers, i in (("olmoe-1b-7b", 2, 0), ("kimi-k2-1t-a32b", 2, 0),
                            ("jamba-v0.1-52b", 8, 1)):
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
        shapes = tfm.params_shape(cfg)
        got = {p: pl.spec for p, pl in tree_flatten_with_path(
            compute_shardings(cfg, shapes, _Mesh(data=16, model=16)))[0]}
        for path, spec in experts.items():
            assert got[path.format(i=i)] == spec, (arch, path)
        if arch == "kimi-k2-1t-a32b":
            assert got["blocks/0/ff/shared_0/w_gate"] == (None, None, "model")
            assert got["blocks/0/ff/shared_0/w_up"] == (None, None, "model")
            assert got["blocks/0/ff/shared_0/w_down"] == (None, "model", None)
        if arch == "jamba-v0.1-52b":  # 128 SSM heads, 8 a rank
            assert all(any(spec) for path, spec in got.items() if "/mixer/" in path
                       and path.split("/")[1] != "4"), "an SSM leaf whole"
        for model in (5, 1):
            plan = compute_shardings(cfg, shapes, _Mesh(data=16, model=model))
            assert not any(any(pl.spec) for path, pl in tree_flatten_with_path(plan)[0]
                           if "/ff/" in path and cfg.pattern_[int(path.split("/")[1])][1]
                           == "moe"), (arch, model)


def test_plan_splits_ssm_heads():
    """SSM layers at full width: Jamba's 128 heads split 8 a rank on (16,
    16) and 32 on (64, 4), Mamba2-130m's 24 split 6 a rank on (64, 4) and
    stay whole on (16, 16), where 16 does not divide 24 (the rule's
    outcome). Split, in_proj's columns are the segments z | x | B | C | dt
    (z, x and dt by heads, B and C whole), the conv's channels x | B | C,
    the per-head leaves, the norm's scale and out_proj's rows by heads."""
    for arch, layers, T, split in (("jamba-v0.1-52b", 8, 16, True), ("jamba-v0.1-52b", 8, 4, True),
                                   ("mamba2-130m", 1, 4, True), ("mamba2-130m", 1, 16, False)):
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
        assert model_split(cfg, T)["ssm"] == split == (cfg.ssm_heads % T == 0)
        got = {p: pl.spec for p, pl in tree_flatten_with_path(compute_shardings(
            cfg, tfm.params_shape(cfg), _Mesh(data=256 // T, model=T)))[0]}
        din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        i = next(j for j, (mixer, _) in enumerate(cfg.pattern_) if mixer == "ssm")
        want = {"in_proj": (None, None, ((din, "model"), (din, "model"), (n, None), (n, None),
                                         (h, "model"))),
                "conv_w": (None, ((din, "model"), (n, None), (n, None)), None),
                "conv_b": (None, ((din, "model"), (n, None), (n, None))),
                "A_log": (None, "model"), "D": (None, "model"), "dt_bias": (None, "model"),
                "norm_scale": (None, "model"), "out_proj": (None, "model", None)}
        for name, spec in want.items():
            path = f"blocks/{i}/mixer/{name}"
            assert got[path] == (spec if split else (None,) * len(spec)), (arch, T, path)
        assert got[f"blocks/{i}/norm1/scale"] == (None, None)


def test_segmented_placement_cuts_boxes_in_segment_order():
    """``Placement`` on a segmented dim: a rank's block is its part of each
    split segment and all of each whole one, joined in segment order
    (``local``), its ``boxes`` are those ranges of the whole with where
    each starts in the block and the axes that pick it, ``local_shape`` /
    ``whole_shape`` go between the two shapes, ``ranges`` refuses a
    segmented block (no one range), and ``worker_grad_spec`` keeps the
    segments."""
    from repro_torch.distributed.sharding import Placement, worker_grad_spec

    segs = ((4, "model"), (4, "model"), (2, None), (2, None), (2, "model"))
    full = torch.arange(3 * 14).reshape(3, 14)
    mesh = _Mesh(data=2, model=2)
    mesh.coords_of = lambda r: {"data": r // 2, "model": r % 2}
    pl = Placement(mesh, (None, segs))
    want = {0: [0, 1, 4, 5, 8, 9, 10, 11, 12], 1: [2, 3, 6, 7, 8, 9, 10, 11, 13]}
    for rank in (0, 1):
        mesh.coords = mesh.coords_of(rank)
        block = pl.local(full)
        assert block.tolist() == [[row * 14 + c for c in want[rank]] for row in range(3)]
        assert block.untyped_storage().nbytes() == block.numel() * block.element_size()
        boxes = pl.boxes(full.shape, rank)
        assert [(b.lo[1], b.hi[1], b.at[1], b.axes) for b in boxes] == [
            (2 * rank, 2 * rank + 2, 0, ("model",)), (4 + 2 * rank, 6 + 2 * rank, 2, ("model",)),
            (8, 10, 4, ()), (10, 12, 6, ()), (12 + rank, 13 + rank, 8, ("model",))]
        for b in boxes:
            assert torch.equal(block[:, b.at[1]:b.at[1] + b.hi[1] - b.lo[1]],
                               full[:, b.lo[1]:b.hi[1]])
    assert pl.local_shape(full.shape) == (3, 9) and pl.whole_shape((3, 9)) == (3, 14)
    assert pl.sharded_dims(2) == (1,) and pl.axes(1) == ("model",) and pl.parts(1) == 2
    with pytest.raises(ValueError, match="boxes"):
        pl.ranges(full.shape)
    assert pl.ranges(full.shape, dims=[0]) == [(0, 3), (0, 14)]
    assert worker_grad_spec(pl, mesh).spec == ("data", None, segs)
    with pytest.raises(ValueError, match="even"):
        Placement(mesh, (((3, "model"), (2, None)),)).local_shape((5,))


def test_replicated_placement_holds_each_block_on_its_replicas():
    """``Placement`` on a replicated-block entry ``("model", 2)`` over a
    model axis of 4: ranks 0, 1 hold block 0 and ranks 2, 3 block 1
    (``local``, each a tensor of its own), its ``boxes`` say so, name the
    model axis and carry ``held`` (2 ranks a block), ``local_shape`` /
    ``whole_shape`` go between the two shapes, ``parts`` is 2 and
    ``replicas`` 2, ``worker_grad_spec`` keeps the entry, the block
    ingress sends each box from replica 0 alone (``packing._sends``), and
    a count that does not divide the axis raises."""
    from repro_torch.distributed import packing
    from repro_torch.distributed.sharding import Placement, worker_grad_spec

    full = torch.arange(3 * 8 * 2).reshape(3, 8, 2)
    mesh = _Mesh(data=2, model=4)
    mesh.coords_of = lambda r: {"data": r // 4, "model": r % 4}
    pl = Placement(mesh, (None, ("model", 2), None))
    for rank in range(8):
        mesh.coords = mesh.coords_of(rank)
        g = mesh.coords["model"] // 2
        block = pl.local(full)
        assert torch.equal(block, full[:, 4 * g:4 * g + 4])
        assert block.untyped_storage().nbytes() == block.numel() * block.element_size()
        (box,) = pl.boxes(full.shape, rank)
        assert box == ((0, 4 * g, 0), (3, 4 * g + 4, 2), (0, 0, 0), ("model",),
                       (("model", 2),))
        assert packing._sends(mesh, rank, box) == (mesh.coords["model"] % 2 == 0)
    assert pl.local_shape(full.shape) == (3, 4, 2) and pl.whole_shape((3, 4, 2)) == (3, 8, 2)
    assert pl.parts(1) == 2 and pl.replicas(1) == 2 and pl.axes(1) == ("model",)
    assert pl.sharded_dims(3) == (1,) and pl.ranges(full.shape, 2) == [(0, 3), (4, 8), (0, 2)]
    assert worker_grad_spec(pl, mesh).spec == ("data", None, ("model", 2), None)
    assert Placement(mesh, (("model", 4),)).replicas(0) == 1
    with pytest.raises(ValueError, match="3 blocks over 4 ranks"):
        Placement(mesh, (("model", 3),)).local_shape((6,))


def test_replicated_blocks_gather_once(tp_ranks):
    """``gather`` of a replicated-block placement rebuilds the whole tensor
    from one copy of each block, bit for bit, on every rank (on (1, 4) two
    blocks of two replicas each; on (2, 2) a plain split in two), and
    ``gather_many`` beside a leaf cut plainly on the model axis gives both
    whole by one all-gather."""
    (_, T), _, ranks = tp_ranks
    for out in ranks:
        got = out["replicated"]
        g = got["index"] // (T // 2)
        assert _same_bits(got["block"], got["full"][:, 4 * g:4 * g + 4])
        assert _same_bits(got["gather"], got["full"])
        assert _same_bits(got["many"][0], got["full"])
        assert _same_bits(got["many"][1], got["other"])


def test_replicas_add_zeros_and_enter_the_same_collectives(tp_ranks):
    """``ModelAxis.project_heads`` over 2 head blocks: the sum over the
    model group is one device's ``x @ w`` (rtol 1e-4, atol 1e-5: the fp32
    order of the partials), each block counted once, on every rank the
    same bits; replica 0 of a block gets one device's gradients of its
    columns and rows, a replica other than 0 exact zeros (it added zeros);
    every rank makes the same collectives (kind, function, bytes) in the
    same order, in ``project_heads`` and in every case's forward and
    backward (``qwen_h6_kv1_remat`` recomputes its period)."""
    (_, T), _, ranks = tp_ranks
    x, w, gout = (t.clone().requires_grad_() for t in torch_shard_ranks.project_heads_inputs())
    one = x @ w
    gx, gw = torch.autograd.grad((one * gout).sum(), [x, w])
    b = x.shape[-1] // 2
    replicas = {out["project_heads"]["replica"] for out in ranks}
    assert replicas == set(range(T // 2))
    for out in ranks:
        got = out["project_heads"]
        np.testing.assert_allclose(got["out"], one.detach(), rtol=RTOL, atol=ATOL)
        assert _same_bits(got["out"], ranks[0]["project_heads"]["out"])
        cols = slice(got["block"] * b, (got["block"] + 1) * b)
        if got["replica"]:
            assert not np.any(np.asarray(got["grads"][0])) and not np.any(got["grads"][1])
        else:
            np.testing.assert_allclose(got["grads"][0], gx[..., cols], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["grads"][1], gw[cols], rtol=RTOL, atol=ATOL)
        assert got["calls"] == ranks[0]["project_heads"]["calls"]
        for label in CASES:
            assert out["cases"][label]["calls"] == ranks[0]["cases"][label]["calls"], label
    assert [c[0] for c in ranks[0]["project_heads"]["calls"]] == ["all-reduce"]


@pytest.mark.parametrize("label", MOE_CASES)
def test_every_rank_routes_as_one_device(tp_ranks, label):
    """Routing is whole on every rank: each MoE layer's top-k experts and
    kept assignments on every rank equal the one-device ``loss_fn``'s bit
    for bit, and ``moe_drop_frac`` equals one device's and the reference's
    exactly (the drop-forcing case drops a fifth or more)."""
    _, _, ranks = tp_ranks
    _, _, _, _, _, routes1, (drop1, rdrop) = _reference(label)
    assert routes1 and drop1 is not None
    assert float(drop1) == float(rdrop)
    if label == "olmoe_drops":
        assert float(drop1) / _case(label)[0].n_layers >= 0.2
    for out in ranks:
        case = out["cases"][label]
        assert len(case["routes"]) == len(routes1)
        for (idx, keep), (idx1, keep1) in zip(case["routes"], routes1):
            assert _same_bits(idx, idx1.numpy()) and _same_bits(keep, keep1.numpy())
        assert _same_bits(case["drop"], drop1)


def test_embedded_stream_is_the_one_device_stream(tp_ranks):
    """The vocab-parallel lookup (a zero row for a token outside the rank's
    rows, the rows all-reduced) gives the one-device stream bit for bit,
    codebooks included, on every rank."""
    _, _, ranks = tp_ranks
    for label in CASES:
        want = _reference(label)[4]
        for out in ranks:
            assert _same_bits(out["cases"][label]["h"], want), label


@pytest.mark.parametrize("arch", list(INGRESS))
def test_block_ingress_equals_rows_to_cols(tp_ranks, arch):
    """Each rank's column slice from the block ingress (its workers' rows,
    its compute blocks; whole leaves, and an SSM leaf's whole B / C
    segments, sent by model coordinate 0 alone; a replicated attention
    block by its replica 0 alone) equals ``shard_cols`` of the packed
    global stack, the slice ``rows_to_cols`` gives, bit for bit, padding
    included. Mamba2's plan has segmented leaves, the 6-head qwen's on
    (1, 4) replicated head blocks (t = 2). The egress of the slice's first
    row to the compute blocks hands each rank, each replica of a head
    block alike, that row's leaves cut by the plan, bit for bit."""
    (_, T), _, ranks = tp_ranks
    for out in ranks:
        got = out["ingress"][arch]
        assert _same_bits(got["blocks"], got["rows_to_cols"])
        segmented = [spec for spec in got["specs"]
                     if any(isinstance(e, tuple) and isinstance(e[0], tuple) for e in spec)]
        assert bool(segmented) == (arch == "mamba2-130m")
        replicated = [spec for spec in got["specs"] if ("model", 2) in spec]
        assert bool(replicated) == (arch == "qwen2.5-14b" and T == 4)
        assert len(got["egress"]) == len(got["row"])
        assert all(_same_bits(a, b) for a, b in zip(got["egress"], got["row"]))


def test_gated_norm_split_sum_matches_one_device(tp_ranks):
    """The SSM's gated RMSNorm on a rank's d_inner / T columns: its fp32 sum
    of squares all-reduced over the model group (``sum_across``), divided
    by the whole d_inner, then ``project_out``: the output on every rank
    and the gradients of the stream's columns, the scale and out_proj's
    rows, put together in rank order, match one device's ``rmsnorm`` and
    product within the stated tolerance (rtol 1e-4, atol 1e-5: the fp32
    sums' order differs)."""
    (_, T), _, ranks = tp_ranks
    from repro_torch.models import ssm

    x = torch_shard_ranks.gated_norm_inputs()
    cfg = configs.smoke_config("mamba2-130m")
    leaves = [x["gated"].clone().requires_grad_(), x["norm_scale"].clone().requires_grad_(),
              x["out_proj"].clone().requires_grad_()]
    out = ssm._gated_out({"norm_scale": leaves[1], "out_proj": leaves[2]}, leaves[0], cfg)
    grads = torch.autograd.grad((out * x["r"]).sum(), leaves)
    group = [r["gated_norm"] for r in ranks[:T]]  # one model group, in rank order
    assert [g["index"] for g in group] == list(range(T))
    for r in ranks:
        np.testing.assert_allclose(r["gated_norm"]["out"], out.detach(), rtol=RTOL, atol=ATOL)
    for i, (want, dim) in enumerate(zip(grads, (-1, 0, 0))):
        got = torch.cat([torch.as_tensor(g["grads"][i]) for g in group], dim=dim)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _step_config(label):
    """The config of a train step on the mesh: gemma at one layer with
    momentum mode ``label``, or the MoE step ``label`` of ``MOE_STEPS``
    (``torch_shard_ranks._tp_steps`` builds the same)."""
    arch, fields = MOE_STEPS.get(label, ("gemma-7b", {"n_layers": 1, "momentum_mode": label}))
    return dataclasses.replace(configs.smoke_config(arch), **fields)


@functools.lru_cache(maxsize=None)
def _one_device_step(mode):
    cfg = _step_config(mode)
    p = _steps_payload()
    step_fn, state = make_train_step(
        cfg, ByzConfig(aggregator="rfa", mixing="bucketing", s=2, worker_momentum=0.9),
        lr=0.05, n_workers=W, device="cpu")
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    params, _, _, metrics = step_fn(params, opt_state, worker_m, torch.tensor(p["mix"]),
                                    {k: torch.tensor(v) for k, v in p["batch"].items()})
    return [x.numpy() for x in tree_flatten(params)[0]], float(metrics["loss"])


@pytest.mark.parametrize("mode", ["worker", "server"] + list(MOE_STEPS))
def test_rows_and_momenta_are_compute_blocks(tp_ranks, mode):
    """The rows a rank hands the sync (server momentum: the raw gradients;
    worker momentum: the momenta) hold exactly its workers' compute blocks,
    the worker momenta are placed by the plan with the worker axes on dim
    0, and the block ingress ran; the step's parameters and loss match the
    one-device step (rtol 1e-4, atol 1e-6). gemma in both modes, and the
    MoE, SSM and head-block steps (``MOE_STEPS``), whose expert rows are
    the rank's experts, whose SSM rows and momenta the rank's heads'
    segments, and whose attention rows and momenta the rank's head block
    (the same block on both replicas of it)."""
    (data, _), _, ranks = tp_ranks
    want_params, want_loss = _one_device_step(mode)
    for out in ranks:
        st = out["steps"][mode]
        assert st["w_local"] == W // data and st["in_shardings"]
        blocks = [(st["w_local"],) + tuple(s) for s in st["compute"]]
        assert st["rows"] == blocks
        if _step_config(mode).momentum_mode == "worker":
            assert st["worker_m"] == blocks
            assert all(spec == ("data",) + tuple(c)
                       for spec, c in zip(st["worker_m_specs"], st["compute_specs"]))
        assert sum(np.prod(b) for b in st["rows"]) < W * sum(x.size for x in want_params)
        for a, b in zip(tree_flatten(st["params"])[0], want_params):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(st["loss"]), want_loss, rtol=1e-5, atol=1e-6)


def test_one_model_rank_keeps_the_route(tp_ranks):
    """On (4, 1) the model axis has one rank: the plan is whole, no
    model-axis operator runs, the rows go in through ``rows_to_cols`` from
    whole leaves, and the step's parameters, optimizer state, loss and
    collectives (kind, function, bytes received, in order) equal those of
    the same step on the bare group, bit for bit: the gathers, one
    all-to-all in of W x n_pad/R fp32, RFA's 8 all-reduces of [W], one
    all-to-all out, the loss's all-reduce."""
    _, _, ranks = tp_ranks
    cfg = configs.smoke_config("qwen2.5-14b")
    n_pad = sum(-(-int(np.prod(s.shape)) // 2048) * 2048
                for s in tree_flatten(tfm.params_shape(cfg))[0])
    for out in ranks:
        one, bare = out["one_model_rank"]["4x1"], out["one_model_rank"]["bare"]
        assert all(not any(s) for s in one["compute_specs"])
        assert one["hits"] == bare["hits"] == {"rows_to_cols": 1, "pack_from_shardings": 0}
        for a, b in zip(tree_flatten((one["params"], one["m"], one["step"], one["loss"]))[0],
                        tree_flatten((bare["params"], bare["m"], bare["step"], bare["loss"]))[0]):
            assert _same_bits(a, b)
        assert one["calls"] == bare["calls"]
        n_gather = sum(1 for s in one["params_specs"] if any(s))
        kinds = [c[0] for c in one["calls"]]
        assert kinds == (["all-gather"] * n_gather + ["all-to-all"] + ["all-reduce"] * 8
                         + ["all-to-all", "all-reduce"])
        assert one["calls"][n_gather][2] == W * (n_pad // 4) * 4
