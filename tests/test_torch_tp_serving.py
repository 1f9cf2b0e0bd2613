"""Serving along the model axis: ``make_prefill_step`` and ``make_serve_step``
on this rank's compute blocks (``sharding.compute_blocks``), held against
the reference's one-device prefill and decode.

4 gloo ranks on the CPU are started once for the module and lay out the
meshes (1, 4) and (2, 2) in turn (``torch_shard_ranks.tp_serving``, which
imports no jax). Each rank cuts its compute blocks of the same
parameters (the port's init as numpy, carried by
``convert.params_from_jax``), prefills a batch and decodes greedily; the
logits are held against the reference's ``make_prefill_step`` and
``decode_step`` on one device at rtol 1e-4 / atol 1e-5 (the tensor-parallel
training tests' bars), with the greedy tokens equal. A batch-sharded step
routes each worker group's rows on their own (a MoE layer's capacity is
counted from the tokens it is handed), so the reference runs each group's
rows at the group's width. The bf16 sequence-sharded decode's distance
from one device is settled at the end (``_softmax_across``).
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from repro import configs as rconfigs
from repro.distributed.steps import make_prefill_step as r_make_prefill_step
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.distributed.sharding import compute_blocks, compute_shardings
from repro_torch.distributed.steps import block_stats, block_values, merge_stats
from repro_torch.models import attention as attn
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as tfm
from repro_torch.models.parallel import model_split
from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_map

#: label -> (arch, config fields): every family and every branch of the
#: plan (``tests/test_torch_tensor_parallel.py``'s), and prefix embeddings
CASES = {
    "gemma": ("gemma-7b", {}),
    "tinyllama_kv2": ("tinyllama-1.1b", {"n_kv_heads": 2, "logit_softcap": 30.0}),
    "whole_attention": ("qwen2.5-14b", {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64}),
    "olmoe": ("olmoe-1b-7b", {}),
    "mamba2": ("mamba2-130m", {}),
    "musicgen": ("musicgen-medium", {}),
    "internvl2": ("internvl2-2b", {}),
    # MoE along the model axis (the tensor-parallel training tests' cases)
    "kimi": ("kimi-k2-1t-a32b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "olmoe_e6": ("olmoe-1b-7b", {"n_experts": 6}),
    "olmoe_drops": ("olmoe-1b-7b", {"capacity_factor": 0.5}),
    # SSM heads along the model axis: 6 heads, split on (2, 2), whole on (1, 4)
    "mamba2_h6": ("mamba2-130m", {"d_model": 192, "ssm_head_dim": 64}),
    # attention in t = 2 head blocks on (1, 4), each held by 2 ranks (the
    # tensor-parallel training tests' cases)
    "qwen_h6": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 2}),
    "qwen_h6_kv1_remat": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 1, "remat": "full"}),
}
MESHES = [(1, 4), (2, 2)]
#: prompt rows and length, greedy tokens after it, cache positions (above
#: the smoke head dim 64, so the rule puts the model axis on the positions)
B, PROMPT, NEW, CACHE = 4, 6, 3, 128
RTOL, ATOL = 1e-4, 1e-5
#: the bf16 sequence-sharded step's seeded cache: positions, 64 a rank on (4, 1)
SEEDED = 256


@functools.lru_cache(maxsize=None)
def _case(label):
    """``(cfg, reference cfg, parameters as numpy, prompt, prefix)``."""
    arch, fields = CASES[label]
    cfg = dataclasses.replace(configs.smoke_config(arch), **fields)
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), **fields)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    lead = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    prompt = rng.integers(0, cfg.vocab_size, lead + (PROMPT,)).astype(np.int32)
    prefix = None
    if cfg.n_prefix_tokens:
        prefix = (rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)) * 0.5).astype(
            np.float32)
    return cfg, rcfg, tree_map(lambda t: t.numpy(), params), prompt, prefix


@functools.lru_cache(maxsize=None)
def _decode_step():
    """The reference's ``decode_step`` jitted (a tenth of its eager time
    here), the config static."""
    return jax.jit(rtfm.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _reference_prefill(label, lo, hi):
    """The reference's one-device prefill (last position) of prompt rows
    ``lo .. hi - 1``."""
    cfg, rcfg, params, prompt, prefix = _case(label)
    batch = {"tokens": jnp.asarray(prompt[lo:hi])}
    if prefix is not None:
        batch["prefix_embeds"] = jnp.asarray(prefix[lo:hi])
    return np.asarray(r_make_prefill_step(rcfg, None)(
        jax.tree_util.tree_map(jnp.asarray, params), batch))


@functools.lru_cache(maxsize=None)
def _reference_decode(label, lo, hi):
    """The reference's one-device greedy decode of prompt rows ``lo .. hi -
    1``: the logits of every step ``[steps, rows, ...]`` and the tokens."""
    cfg, rcfg, params, prompt, _ = _case(label)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    cache = rtfm.init_cache(rcfg, hi - lo, CACHE)
    step = _decode_step()
    logits_seq, chosen = [], []
    for pos in range(PROMPT + NEW):
        tok = jnp.asarray(prompt[lo:hi, ..., pos]) if pos < PROMPT else chosen[-1]
        logits, cache = step(rp, rcfg, cache, tok, jnp.asarray(pos, jnp.int32))
        logits_seq.append(np.asarray(logits))
        chosen.append(jnp.argmax(logits, axis=-1))
    return np.stack(logits_seq), np.stack([np.asarray(t) for t in chosen])


def _expected(label, rows, groups):
    """The reference's prefill and decode of the first ``rows`` prompt rows as
    ``groups`` worker groups serve them, each its own rows: a MoE layer
    counts its capacity from the tokens it is handed, so a MoE model's
    groups run apart; any other model's rows do not meet, and run at once.
    ``(prefill, decode logits, decode tokens)``."""
    cfg = _case(label)[0]
    g = groups if any(ff == "moe" for _, ff in cfg.pattern_) else 1
    b = rows // g
    pre = [_reference_prefill(label, i * b, (i + 1) * b) for i in range(g)]
    dec = [_reference_decode(label, i * b, (i + 1) * b) for i in range(g)]
    return (np.concatenate(pre), np.concatenate([d[0] for d in dec], axis=1),
            np.concatenate([d[1] for d in dec], axis=1))


def _payload():
    cases = {}
    for label, (arch, fields) in CASES.items():
        _, _, params, prompt, prefix = _case(label)
        cases[label] = {"arch": arch, "cfg": fields, "params": params, "prompt": prompt}
        if prefix is not None:
            cases[label]["prefix"] = prefix
    softmax = {"cfg": CASES["tinyllama_kv2"][1], "params": cases["tinyllama_kv2"]["params"],
               "length": SEEDED, "token": 77}
    return {"meshes": MESHES, "cases": cases, "cache_len": CACHE, "new_tokens": NEW,
            "one_model_rank": ["gemma", "musicgen", "olmoe", "kimi"], "softmax": softmax}


@pytest.fixture(scope="module")
def group():
    """Every rank's results of ``tp_serving``: one group runs both meshes.
    While the ranks run, this process computes the reference's prefill and
    decode the tests read, two cases at a time (cached; one that raises is
    left for its test to raise)."""

    def warm(label):
        for rows, groups in [(B, data) for data, _ in MESHES] + [(1, 1)]:
            with contextlib.suppress(Exception):
                _expected(label, rows, groups)

    with concurrent.futures.ThreadPoolExecutor(1) as pool, \
            concurrent.futures.ThreadPoolExecutor(2) as refs:
        ranks = pool.submit(spawn_ranks, torch_shard_ranks.tp_serving, 4, backend="gloo",
                            devices=["cpu"] * 4, args=(_payload(),), timeout_s=600)
        list(refs.map(warm, CASES))
        return ranks.result()


@pytest.fixture(params=MESHES, ids=["1x4", "2x2"])
def ranks(request, group):
    """Every rank's results on one mesh."""
    return request.param, [r[request.param] for r in group]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


class _Mesh:
    """What ``compute_shardings`` and ``Placement.local_shape`` read of a
    mesh: ``shape``, ``axis_names`` and this rank's ``coords``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.coords = {a: 0 for a in axes}


@pytest.mark.parametrize("label", list(CASES))
def test_prefill_on_compute_blocks(ranks, label):
    """The last-position logits of all V (each codebook's), prefilled on
    each rank's compute blocks, against the reference's one-device prefill
    of each worker group's rows (rtol 1e-4, atol 1e-5); the same bits on
    every rank of a model group."""
    (data, T), out = ranks
    want = _expected(label, B, data)[0]
    for r, o in enumerate(out):
        got = o["cases"][label]["prefill"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert _same_bits(got, out[r - r % T]["cases"][label]["prefill"])


@pytest.mark.parametrize("label", list(CASES))
def test_greedy_decode_on_compute_blocks(ranks, label):
    """A greedy decode through ``make_serve_step`` on compute blocks, from a
    6-token prompt for 3 new tokens over a 128-position cache: all 4 rows
    (batch-sharded over data, the positions over model), and on (2, 2) one
    row (sequence-sharded over data, the kv heads over model where they
    divide). Every step's logits match the reference's ``decode_step`` on
    each worker group's rows (rtol 1e-4, atol 1e-5), the greedy tokens are
    equal, every rank holds the same logits."""
    (data, _), out = ranks
    runs = [("batch", B, data)] + ([("single", 1, 1)] if data > 1 else [])
    for cache, rows, groups in runs:
        _, logits, toks = _expected(label, rows, groups)
        for o in out:
            got = o["cases"][label][cache]
            np.testing.assert_allclose(got["logits"], logits, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(got["tokens"], toks)
            assert _same_bits(got["logits"], out[0]["cases"][label][cache]["logits"])


def test_cache_placements_the_decode_met(ranks):
    """The placements the cases' caches took, as the reference's
    ``cache_shardings`` gives them: all rows with the model axis on the
    positions (dim 2) of the 128-position cache; one row on (2, 2) with the
    positions over data and the kv heads over model where they divide."""
    (data, T), out = ranks
    cases = out[0]["cases"]
    assert cases["gemma"]["batch"]["spec"] == (None, "data", "model", None, None)
    if data > 1:
        assert cases["gemma"]["single"]["spec"] == (None, None, "data", "model", None)
        assert cases["tinyllama_kv2"]["single"]["spec"] == (None, None, "data", "model", None)
        assert cases["whole_attention"]["single"]["spec"] == (None, None, "data", None, None)
    else:
        assert all("single" not in case for case in cases.values())


def test_ranks_hold_only_their_blocks(ranks):
    """Each rank's parameter bytes are the plan's blocks: its shapes are
    ``compute_shardings``' local shapes, each block a tensor of its own (its
    storage no larger than its bytes), and the split parts' bytes 1 / T of
    the whole (gemma: everything but the norms split)."""
    (data, T), out = ranks
    for label in CASES:
        cfg = _case(label)[0]
        specs = tfm.params_shape(cfg)
        plan = compute_shardings(cfg, specs, _Mesh(data=data, model=T))
        want = [pl.local_shape(s.shape) for s, pl in zip(tree_flatten(specs)[0],
                                                       tree_flatten(plan)[0])]
        nbytes = sum(math.prod(shape) * 4 for shape in want)
        for o in out:
            case = o["cases"][label]
            assert case["shapes"] == want, label
            assert case["bytes"] == case["storage"] == nbytes, label
    cfg = _case("gemma")[0]
    whole = sum(math.prod(s.shape) * 4 for s in tree_flatten(tfm.params_shape(cfg))[0])
    norms = 4 * cfg.d_model * (2 * cfg.n_layers + 1)
    assert out[0]["cases"]["gemma"]["bytes"] == (whole - norms) // T + norms
    assert all(v for k, v in model_split(cfg, T).items()
               if not k.startswith("moe") and k != "ssm")  # gemma: no experts, no SSM
    # the experts: E / T of the stacked leaves a rank, where T divides E
    for label in ("olmoe", "kimi", "jamba", "olmoe_e6"):
        cfg = _case(label)[0]
        split = cfg.n_experts % T == 0
        for o in out:
            for (path, s), shape in zip(tree_flatten_with_path(tfm.params_shape(cfg))[0],
                                        o["cases"][label]["shapes"]):
                if path.split("/")[-1] in ("w_gate", "w_up", "w_down") and "shared" not in path \
                        and cfg.pattern_[int(path.split("/")[1])][1] == "moe":
                    assert math.prod(shape) * (T if split else 1) == math.prod(s.shape), path
                    assert shape[1] == cfg.n_experts // (T if split else 1), path


@pytest.mark.parametrize("label", ["qwen_h6", "qwen_h6_kv1_remat"])
def test_head_blocks_decode_collectives(ranks, label):
    """One decode step of the 6-head qwens (all rows, batch-sharded) on
    their head blocks (t = 2; on (1, 4) each held by 2 ranks): every rank
    holds only its block of wq / wk / wv / wo (and the biases; whole wk /
    wv where the one kv head does not split), and the step makes, beside
    the embedding's all-reduce and the vocab's all-gather, one all-gather
    a layer (the token's q, and k / v where they split, of every head
    block, ``parallel.gather_heads``), two more a layer for the softmax
    across the cache's positions, which the rules put on the model axis
    (``steps._softmax_across``: the blocks' statistics and values, as the
    whole-attention route makes them), and two all-reduces a layer (the
    attention's ``project_out`` and the MLP's), the same kinds in the same
    order on every rank."""
    (_, T), out = ranks
    cfg = _case(label)[0]
    flags = model_split(cfg, T)
    assert flags["attn"] and flags["t"] == 2 and flags["kv"] == (cfg.n_kv_heads == 2)
    dh, L = cfg.head_dim_, cfg.n_layers
    paths = [p for p, _ in tree_flatten_with_path(tfm.params_shape(cfg))[0]]
    for o in out:
        shapes = dict(zip(paths, o["cases"][label]["shapes"]))
        assert shapes["blocks/0/mixer/wq"] == (L, cfg.d_model, cfg.n_heads * dh // 2)
        assert shapes["blocks/0/mixer/wo"] == (L, cfg.n_heads * dh // 2, cfg.d_model)
        kv = cfg.n_kv_heads * dh // (2 if flags["kv"] else 1)
        assert shapes["blocks/0/mixer/wk"] == shapes["blocks/0/mixer/wv"] == (L, cfg.d_model, kv)
        assert shapes["blocks/0/mixer/bk"] == (L, kv)
        kinds = o["cases"][label]["batch"]["step_calls"]
        assert kinds == out[0]["cases"][label]["batch"]["step_calls"]
        assert o["cases"][label]["batch"]["spec"][2] == "model"
        assert kinds.count("all-gather") == 1 + 3 * L, kinds
        assert kinds.count("all-reduce") == 1 + 2 * L, kinds
        assert set(kinds) == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("label", ["mamba2", "mamba2_h6"])
def test_ssm_caches_exchange_once_a_step(ranks, label):
    """One decode step of the SSM models (all rows, batch-sharded): where
    the model axis splits the SSM heads the step decodes on the compute
    blocks of the state and conv ring, brought from and back to the
    reference's cache placement by one all-gather each way for every
    layer's caches, beside the vocab's gather; each SSM layer makes two
    all-reduces (the gated norm's sum of squares and ``project_out``), the
    embedding one. Where T does not divide the heads (``mamba2_h6`` on
    (1, 4)) the layers run whole: each cache leaf the rules split is
    gathered whole and cut after, and no layer all-reduces. Every rank
    holds its heads' blocks of the SSM leaves where they split."""
    (data, T), out = ranks
    cfg = _case(label)[0]
    split = model_split(cfg, T)["ssm"]
    n_leaves = 2  # one SSM layer's conv ring and state, stacked over the layers
    for o in out:
        kinds = o["cases"][label]["batch"]["step_calls"]
        want_gathers = 1 + (2 if split else n_leaves)
        assert kinds.count("all-gather") == want_gathers, kinds
        assert kinds.count("all-reduce") == 1 + (2 * cfg.n_layers if split else 0), kinds
        assert set(kinds) <= {"all-gather", "all-reduce"}
        shapes = dict(zip([p for p, _ in tree_flatten_with_path(tfm.params_shape(cfg))[0]],
                          o["cases"][label]["shapes"]))
        h = cfg.ssm_heads // (T if split else 1)
        assert shapes["blocks/0/mixer/A_log"] == (cfg.n_layers, h)
        assert shapes["blocks/0/mixer/in_proj"][-1] == (
            2 * cfg.d_inner + cfg.ssm_heads) // (T if split else 1) + 2 * cfg.ssm_state


def test_whole_parameters_raise(ranks):
    """Whole parameters on a mesh whose model axis has T > 1 ranks: both
    steps raise a ``ValueError`` naming the cutting function, and gather
    nothing."""
    _, out = ranks
    for o in out:
        raised = o["whole_raises"]
        assert len(raised["messages"]) == 2 and raised["calls"] == 0
        assert all("sharding.compute_blocks" in msg for msg in raised["messages"])


@pytest.mark.parametrize("label", ["gemma", "musicgen", "olmoe", "kimi"])
def test_one_model_rank_keeps_todays_bits(group, label):
    """On the (4, 1) mesh the model axis has one rank: no ``ModelAxis``, the
    prefill's and every decode step's logits equal bit for bit those of
    ``forward_hidden`` / ``unembed`` and ``decode_step`` called on the
    rank's rows with whole parameters, and neither step makes a
    collective."""
    for o in group:
        one = o["one_model_rank"][label]
        assert one["axis"] is None and one["calls"] == 0 and one["decode_calls"] == 0
        assert _same_bits(*one["prefill"])
        assert len(one["decode"]) == PROMPT
        assert all(_same_bits(a, b) for a, b in one["decode"])


def test_compute_blocks_are_tensors_of_their_own(tmp_path):
    """``compute_blocks`` on whole parameters and a plan that splits them:
    each split leaf a copy (its own storage, the block's bytes), each whole
    leaf the tensor itself, the blocks the plan's ranges of the whole; a
    checkpoint's whole leaves, restored, cut to the same blocks."""
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    cfg = _case("gemma")[0]
    whole = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    mesh = _Mesh(data=1, model=2)
    mesh.coords = {"data": 0, "model": 1}
    blocks = compute_blocks(cfg, whole, mesh)
    plan = compute_shardings(cfg, whole, mesh)
    for x, b, pl in zip(tree_flatten(whole)[0], tree_flatten(blocks)[0], tree_flatten(plan)[0]):
        if any(pl.spec):
            assert b.untyped_storage().nbytes() == b.numel() * b.element_size() < \
                x.numel() * x.element_size()
            index = tuple(slice(*r) for r in pl.ranges(x.shape))
            assert torch.equal(b, x[index])
        else:
            assert b is x
    save_checkpoint(str(tmp_path), 1, whole)
    restored = compute_blocks(cfg, restore_checkpoint(str(tmp_path), whole), mesh)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(restored)[0],
                                                  tree_flatten(blocks)[0]))


def _bf16_step(x):
    """One bf16 step (unit in the last place) at the magnitude of each of ``x``."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _rank_order(blocks, dtype):
    """``_softmax_across``'s arithmetic on one device: the position blocks'
    (logits, values) statistics merged and their fp32 shares summed in
    rank order, before the one rounding."""
    B, h = blocks[0][0].shape[:2]
    m_all, l_all = merge_stats(torch.stack([block_stats(lg) for lg, _ in blocks]), B, h)
    return torch.sum(torch.stack([block_values(lg, v, m_all, l_all, dtype)
                                  for lg, v in blocks]), dim=0)


def test_bf16_sequence_sharded_gap_is_the_rounding_order(group):
    """Settles why the bf16 sequence-sharded decode's logits sat 0.125 from
    one device's on the card (TinyLlama, 22 layers, 4,096 positions over 4
    ranks; each run 0.17-0.18 from fp32): the order of the fp32 sums. One
    bf16 step of smoke TinyLlama (2 kv heads, softcap) on a
    seeded 256-position cache, sequence-sharded over the (4, 1) mesh: in
    every layer the combine's fp32 sums over all ranks, before their one
    rounding, agree with one device's fp32 accumulation of the same bf16
    probabilities times the values to fp32 accumulation order (rtol 1e-6,
    atol 1e-7; under 1 / 16 of a bf16 step of the output), so its bf16
    output differs from ``softmax_values``' by at most one bf16 step, where
    a sum lies that close to a rounding boundary. One device summing in
    the mesh's order (``block_stats``, ``merge_stats``, ``block_values``
    over the ranks' blocks in rank order) gives the mesh's sums bit for
    bit, and a whole ``decode_step`` through that combine gives the mesh's
    logits bit for bit: the gap is the rounding order and nothing else."""
    bf = torch.bfloat16
    per_rank = [o["softmax"] for o in group]
    assert per_rank[0]["spec"] == (None, None, "data", "model", None)  # model of size 1
    for layer in range(len(per_rank[0]["records"])):
        recs = [{k: torch.as_tensor(v) for k, v in r["records"][layer].items()}
                for r in per_rank]
        blocks = [(r["logits"], r["values"].to(bf)) for r in recs]
        logits = torch.cat([lg for lg, _ in blocks], dim=-1)
        values = torch.cat([v for _, v in blocks], dim=1)
        one = attn.softmax_values(logits, values, bf).float()
        probs = torch.softmax(logits, dim=-1).to(bf).float()
        one32 = torch.einsum("bhqk,bkhd->bqhd", probs, values.float())
        for r in recs:
            assert torch.equal(r["sums"], recs[0]["sums"]) and torch.equal(r["out"], recs[0]["out"])
        mesh32, mesh = recs[0]["sums"], recs[0]["out"]
        np.testing.assert_allclose(mesh32.numpy(), one32.numpy(), rtol=1e-6, atol=1e-7)
        assert torch.all((mesh32 - one32).abs() <= _bf16_step(one) / 16)
        assert torch.all((mesh - one).abs() <= _bf16_step(one))
        assert torch.equal(_rank_order(blocks, bf), mesh32)
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), dtype="bfloat16",
                              **CASES["tinyllama_kv2"][1])
    params = tree_map(lambda t: torch.as_tensor(t).to(bf), _case("tinyllama_kv2")[2])
    n = len(group)

    def in_rank_order(logits, v_e, dtype):
        b = logits.shape[-1] // n
        return _rank_order([(logits[..., i * b:(i + 1) * b], v_e[:, i * b:(i + 1) * b])
                            for i in range(n)], dtype).to(dtype)

    cache = torch_shard_ranks.seeded_cache(cfg, SEEDED, SEEDED - 1)
    token, pos = torch.tensor([77]), SEEDED - 1
    ordered, _ = tfm.decode_step(params, cfg, cache, token, pos, attend=lambda i, p, x, c, q: (
        attn.decode_attention(p, x, c, cfg, q, combine=in_rank_order)))
    for o in per_rank:
        assert _same_bits(o["logits"], ordered.float().numpy())


def test_row_split_product_keeps_one_devices_rounding(group):
    """``ModelAxis.project_out`` on bf16 where the experts are split: each
    rank's partial of the row-split product in fp32, the partials summed,
    the sum rounded once, as one device's bf16 product accumulates in fp32
    and rounds once. On the (1, 4) mesh it equals one device's ``x @ w``
    but where the fp32 sums' order moves a value across a bf16 rounding
    boundary (at most one bf16 step, in under 1 % of the elements), and
    every rank holds the same bits; the bf16 partials summed in bf16
    (``reduce_out`` of each rank's rounded product) stray more often. Its
    gradients are the bf16 route's bit for bit, and on an axis without
    split experts it is that route."""
    x, w = torch_shard_ranks.project_out_inputs()
    one = (x @ w).float()
    got = [torch.as_tensor(o["project_out"]["project_out"]) for o in group]
    assert all(torch.equal(g, got[0]) for g in got)
    off = got[0] != one
    assert float(off.float().mean()) < 0.01
    assert torch.all((got[0] - one).abs() <= _bf16_step(one))
    for o in group:
        old = torch.as_tensor(o["project_out"]["bf16_partials"])
        assert torch.equal(torch.as_tensor(o["project_out"]["dense"]), old)
        grads = o["project_out"]["grads"]
        assert all(np.array_equal(a, b) for a, b in zip(grads["project_out"],
                                                        grads["bf16_partials"]))
    assert int((old != one).sum()) > int(off.sum())
