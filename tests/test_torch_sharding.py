"""The port's sharding layer (``distributed/sharding.py``, ``launch/mesh.py``
and their users in ``packing``, ``robust_sync`` and ``steps``) held
against the reference.

The rules: the reference's rule functions run on ``tests/test_steps.py``'s
``_FakeMesh`` with ``NamedSharding`` patched to return the bare
``PartitionSpec``, so that every leaf of every arch's full-width tree is
compared spec for spec on meshes of up to 512 devices without one.

The groups: 4 gloo ranks on the CPU laid out as the meshes (4, 1) and
(2, 2) (``torch_shard_ranks.run_mesh``, which imports no jax), each
started once per module. The reference's multi-device steps fail under
this tree's jax, so the one-device port and the reference's single-device
functions are the oracles.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.distributed.sharding as rsharding
import torch_shard_ranks
from repro import configs as rconfigs
from repro.core.aragg import RobustAggregator as RRobustAggregator
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding
from repro_torch.distributed.steps import make_prefill_step, make_train_step
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as tfm
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_map

ARCHS = configs.list_archs()
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}, "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}}


class _FakeMesh:
    """The port's rules read ``axis_names`` and ``shape``; the reference's
    ``axis_names`` and ``devices.shape`` (``tests/test_steps.py``)."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.devices = np.empty(tuple(axes.values()), dtype=np.int8)


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's placement functions return bare ``PartitionSpec``s."""
    monkeypatch.setattr(rsharding, "NamedSharding", lambda mesh, spec: spec)


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {rsharding._path_str(path): tuple(spec) for path, spec in flat}


def _port_specs(tree):
    return {path: pl.spec for path, pl in tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The full-width parameter trees: the reference's ``eval_shape`` and the
    port's ``params_shape``."""
    rshape = jax.eval_shape(lambda: rtfm.init_params(rconfigs.get_config(arch),
                                                     jax.random.PRNGKey(0)))
    return rshape, tfm.params_shape(configs.get_config(arch))


# ------------------------------------------------------------------- rules
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(bare_specs, arch, mesh_name):
    """Every leaf's spec, fsdp off and on, with and without the config's
    overrides; the paths are the reference's strings."""
    mesh = _FakeMesh(MESHES[mesh_name])
    rshape, shape = _shapes(arch)
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    for fsdp in (False, True):
        for with_overrides in (False, True):
            want = _ref_specs(rsharding.param_shardings(
                rshape, mesh, fsdp=fsdp,
                overrides=rsharding.overrides_from_config(rcfg) if with_overrides else None))
            got = _port_specs(sharding.param_shardings(
                shape, mesh, fsdp=fsdp,
                overrides=sharding.overrides_from_config(cfg) if with_overrides else None))
            assert got == want, (arch, fsdp, with_overrides)
    assert {p for p, _ in tree_flatten_with_path(shape)[0]} == set(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(bare_specs, arch):
    """``cache_shardings`` at batch 1 (sequence-sharded), 2 and 8, on every
    mesh."""
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    for batch in (1, 2, 8):
        rshape = jax.eval_shape(lambda: rtfm.init_cache(rcfg, batch, 4096))
        shape = tfm.cache_shape(cfg, batch, 4096)
        assert ({p: s.shape for p, s in tree_flatten_with_path(shape)[0]}
                == {rsharding._path_str(p): tuple(s.shape)
                    for p, s in jax.tree_util.tree_flatten_with_path(rshape)[0]})
        for axes in MESHES.values():
            mesh = _FakeMesh(axes)
            assert (_port_specs(sharding.cache_shardings(shape, mesh, batch))
                    == _ref_specs(rsharding.cache_shardings(rshape, mesh, batch))), (batch, axes)


def test_gemma_override_lands_on_embed():
    """gemma-7b's override puts the tied embed on ("data", "model") where
    the inferred rule would not; the other leaves are untouched."""
    cfg = configs.get_config("gemma-7b")
    assert sharding.overrides_from_config(cfg) == {"^embed$": ("data", "model")}
    assert sharding.overrides_from_config(configs.get_config("tinyllama-1.1b")) == {}
    mesh = _FakeMesh(MESHES["16x16"])
    _, shape = _shapes("gemma-7b")
    placed = sharding.param_shardings(shape, mesh, fsdp=cfg.fsdp,
                                      overrides=sharding.overrides_from_config(cfg))
    plain = sharding.param_shardings(shape, mesh, fsdp=cfg.fsdp)
    assert placed["embed"].spec == ("data", "model") != plain["embed"].spec
    for path, pl in tree_flatten_with_path(plain)[0]:
        if path != "embed":
            assert dict(tree_flatten_with_path(placed)[0])[path].spec == pl.spec


def test_infer_param_spec_model_axis():
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert sharding.infer_param_spec("lm_head", (512, 4096), mesh) == (None, "model")


def test_infer_param_spec_blocks_skips_period_axis():
    mesh = _FakeMesh({"data": 16, "model": 16})
    spec = sharding.infer_param_spec("blocks/0/ff/w_up", (22, 512, 2048), mesh)
    assert spec[0] is None and "model" in spec


def test_infer_param_spec_fsdp():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = sharding.infer_param_spec("blocks/0/ff/w_up", (22, 8192, 4096), mesh, fsdp=True)
    assert "model" in spec
    assert ("pod", "data") in spec or "data" in spec


def test_batch_spec_worker_axes():
    assert sharding.batch_spec(_FakeMesh({"pod": 2, "data": 16, "model": 16})) == (
        ("pod", "data"),)
    assert sharding.batch_spec(_FakeMesh({"data": 16, "model": 16})) == ("data",)


@dataclasses.dataclass
class _Sharding:
    spec: P


def test_worker_grad_spec_keeps_model_drops_fsdp(bare_specs):
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    for spec in [(None, "model"), (("pod", "data"), "model"), ("data", None, "model")]:
        # the reference reads .spec off a NamedSharding
        want = rsharding.worker_grad_spec(_Sharding(P(*spec)), mesh)
        got = sharding.worker_grad_spec(sharding.Placement(mesh, spec), mesh)
        assert got.spec == tuple(want)


def test_tree_paths_match_the_reference():
    """``tree_flatten_with_path`` gives the reference's key strings for the
    parameters, an optimizer state (NamedTuple fields, ``None`` skipped)
    and lists."""
    from repro.optim import make_optimizer as r_make_optimizer
    from repro_torch.optim import make_optimizer

    rcfg, cfg = rconfigs.smoke_config("gemma-7b"), configs.smoke_config("gemma-7b")
    rp = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    tree = {"params": rp, "opt_state": r_make_optimizer("sgdm")[0](rp), "l": [rp["embed"]]}
    want = [rsharding._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    got = [p for p, _ in tree_flatten_with_path(
        {"params": tp, "opt_state": make_optimizer("sgdm")[0](tp), "l": [tp["embed"]]})[0]]
    assert got == want
    assert "opt_state/m/blocks/0/ff/w_up" in got and "opt_state/step" in got


# ------------------------------------------------------------------ groups
W = 8
EGRESS_RULES = {"cm": ("cm", {}), "tm": ("tm", {"n_trim": 2}), "rfa": ("rfa", {}),
                "krum": ("krum", {"n_byzantine": 2}), "cclip": ("cclip", {"tau": 3.0})}
TRAIN_W, TRAIN_STEPS = 4, {"rfa": 2, "cm": 1}
TRAIN_CFG = {"n_layers": 1}
SERVE_CFG = {"n_kv_heads": 2}
SERVE_B, PROMPT, NEW, CACHE = 4, 8, 6, 16


def _xs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mix(agg, kwargs, n, seed):
    ra = RRobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
    return np.asarray(ra.mixing_matrix(jax.random.PRNGKey(seed), n))


@functools.lru_cache(maxsize=None)
def _serve_params():
    rcfg = dataclasses.replace(rconfigs.smoke_config("tinyllama-1.1b"), **SERVE_CFG)
    rp = rtfm.init_params(rcfg, jax.random.PRNGKey(4))
    return rcfg, jax.tree_util.tree_map(np.asarray, rp)


@functools.lru_cache(maxsize=None)
def _qwen_params():
    rp = rtfm.init_params(rconfigs.smoke_config("qwen2.5-14b"), jax.random.PRNGKey(6))
    return jax.tree_util.tree_map(np.asarray, rp)


def _train_batch():
    toks = np.random.default_rng(21).integers(0, 512, (2 * TRAIN_W, 17))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _payload(mesh_shape, ckpt_dir):
    shapes = {"w": (W, 16, 48), "b": (W, 8, 64), "v": (W, 4, 256), "u": (W, 3, 5), "s": (W,)}
    _, rp = _serve_params()
    return {
        "mesh": mesh_shape,
        "tree": {k: _xs(s, seed=i) for i, (k, s) in enumerate(shapes.items())},
        "mixes": {label: (agg, kw, _mix(agg, kw, W, 7)) for label, (agg, kw)
                  in EGRESS_RULES.items()},
        "train": {"arch": "gemma-7b", "cfg": TRAIN_CFG, "W": TRAIN_W, "lr": 0.05,
                  "batch": _train_batch(), "ckpt_dir": ckpt_dir,
                  "runs": {agg: [_mix(agg, {}, TRAIN_W, 30 + t) for t in range(n)]
                           for agg, n in TRAIN_STEPS.items()}},
        "qwen_params": _qwen_params(),
        "serve": {"arch": "tinyllama-1.1b", "cfg": SERVE_CFG, "params": rp,
                  "prompt": np.random.default_rng(5).integers(0, 512, (SERVE_B, PROMPT)),
                  "cache_len": CACHE, "new_tokens": NEW},
    }


@pytest.fixture(scope="module", params=[(4, 1), (2, 2)], ids=["4x1", "2x2"])
def mesh_ranks(request, tmp_path_factory):
    """Every rank's results of ``run_mesh`` on one mesh, with the payload."""
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    payload = _payload(request.param, ckpt)
    ranks = spawn_ranks(torch_shard_ranks.run_mesh, 4, backend="gloo", devices=["cpu"] * 4,
                        args=(payload,), timeout_s=600)
    return request.param, payload, ranks


def _equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert np.asarray(x).shape == np.asarray(y).shape
        np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))


def test_mesh_coordinates(mesh_ranks):
    """Row-major coordinates, as ``jax.make_mesh`` lays devices out; on a
    ("pod", "data", "model") mesh of the same group a dim placed on
    ("pod", "data") is cut by the combined coordinate and gathered back,
    and ``constrain_worker_tree`` cuts each rank's worker rows."""
    shape, _, ranks = mesh_ranks
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(ranks):
        assert out["coords"] == {"data": r // shape[1], "model": r % shape[1]}
        assert out["worker_axes"] == ("data",) and out["n_workers"] == shape[0]
        three = out["three_axes"]
        assert three["coords"] == {"pod": r // 2, "data": r % 2, "model": 0}
        assert three["worker_axes"] == ("pod", "data") and three["n_workers"] == 4
        np.testing.assert_array_equal(three["block"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(three["rows"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(three["gathered"], full)


def test_serve_step_executes(mesh_ranks):
    """``tests/test_steps.py``'s case on the mesh: smoke qwen2.5-14b, batch
    2 against a 64-position cache (sequence-sharded on 4x1, where 2 rows
    do not split over 4 workers; batch-sharded on 2x2); the logits are
    finite and equal the one-device step's (1e-5)."""
    shape, payload, ranks = mesh_ranks
    cfg = configs.smoke_config("qwen2.5-14b")
    cache = tfm.init_cache(cfg, 2, 64, device="cpu")
    want, _ = tfm.decode_step(params_from_jax(payload["qwen_params"], "cpu"), cfg, cache,
                              torch.zeros(2, dtype=torch.long), 0)
    for out in ranks:
        q = out["qwen"]
        assert q["local"] == ((2, cfg.vocab_size) if shape[0] == 4 else (1, cfg.vocab_size))
        assert q["logits"].shape == (2, cfg.vocab_size) and np.all(np.isfinite(q["logits"]))
        np.testing.assert_allclose(q["logits"], want.numpy(), rtol=1e-5, atol=1e-5)


def test_batch_shardings_equal_the_reference(monkeypatch):
    """``batch_shardings``: the batch dim over the worker axes where they
    divide it, every input of the train, prefill and decode shapes."""
    import repro.distributed.steps as rsteps
    from repro.configs.base import InputShape as RInputShape
    from repro.distributed.steps import batch_shardings as r_batch_shardings

    monkeypatch.setattr(rsteps, "NamedSharding", lambda mesh, spec: spec)
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.steps import batch_shardings

    for arch in ("tinyllama-1.1b", "internvl2-2b", "musicgen-medium"):
        for kind, B in (("train", 8), ("prefill", 2), ("decode", 1), ("decode", 32)):
            for axes in MESHES.values():
                mesh = _FakeMesh(axes)
                want = r_batch_shardings(rconfigs.get_config(arch),
                                         RInputShape("t", 128, B, kind), mesh)
                got = batch_shardings(configs.get_config(arch), InputShape("t", 128, B, kind),
                                      mesh)
                assert {k: pl.spec for k, pl in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (arch, kind, B, axes)


@pytest.mark.parametrize("label", list(EGRESS_RULES))
def test_param_sharded_egress_equals_replicated(mesh_ranks, label):
    """The FSDP egress gives each rank the replicated egress's leaves, cut
    to its blocks, bit for bit; the rank receives exactly its blocks'
    elements in the egress all_to_all, never calls the replicated
    ``unshard_cols``, and telemetry counts ``n_params * 4`` bytes."""
    _, payload, ranks = mesh_ranks
    n_params = sum(int(np.prod(v.shape[1:])) for v in payload["tree"].values())
    for out in ranks:
        run = out["egress"]["rules"][label]
        _equal(run["sharded"], run["cut"])
        assert run["unshard_calls"] == 0
        assert run["egress_recv"][-1] == run["block_elems"] < n_params
        assert run["egress_bytes"] == n_params * 4
    assert any(any(e is not None for e in spec) for spec in ranks[0]["egress"]["specs"].values())


@pytest.mark.parametrize("label", list(EGRESS_RULES))
def test_per_leaf_engine_on_the_mesh(mesh_ranks, label):
    """The per-leaf engine's kernel route over the ranks: CM and TM equal the
    packed engine's bit for bit (column-local), the Gram rules within
    1e-5; every rank holds the same result, and ``out_shardings`` cuts it."""
    _, _, ranks = mesh_ranks
    for out in ranks:
        run = out["egress"]["rules"][label]
        if label in ("cm", "tm"):
            _equal(run["per_leaf"], run["replicated"])
        else:
            for a, b in zip(jax.tree_util.tree_leaves(run["per_leaf"]),
                            jax.tree_util.tree_leaves(run["replicated"])):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        _equal(run["per_leaf"], ranks[0]["egress"]["rules"][label]["per_leaf"])
        for a, b in zip(jax.tree_util.tree_leaves(run["per_leaf_cut"]),
                        jax.tree_util.tree_leaves(run["cut"])):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _one_device_train(agg):
    cfg = dataclasses.replace(configs.smoke_config("gemma-7b"), **TRAIN_CFG)
    step_fn, state = make_train_step(cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2),
                                     lr=0.05, n_workers=TRAIN_W, device="cpu")
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    batch = {k: torch.tensor(v) for k, v in _train_batch().items()}
    losses = []
    for t in range(TRAIN_STEPS[agg]):
        params, opt_state, worker_m, metrics = step_fn(
            params, opt_state, worker_m, torch.tensor(_mix(agg, {}, TRAIN_W, 30 + t)), batch)
        losses.append(float(metrics["loss"]))
    return params, opt_state, losses


@pytest.mark.parametrize("agg", list(TRAIN_STEPS))
def test_fsdp_train_step_on_the_mesh(mesh_ranks, agg):
    """gemma's fsdp step over the mesh: each rank holds only its blocks
    (the override puts embed on ("data", "model")); the gathered
    parameters and optimizer momenta equal the replicated step's (fsdp
    off, same mesh) bit for bit on every rank, and the one-device step's
    within rtol 1e-4 / atol 1e-6; the losses are the mean over all
    workers."""
    shape, _, ranks = mesh_ranks
    want_params, want_opt, want_losses = _one_device_train(agg)
    n_params = sum(int(x.numel()) for x in tree_flatten(want_params)[0])
    for out in ranks:
        fsdp, rep = out["train"][(True, agg)], out["train"][(False, agg)]
        assert fsdp["specs"]["embed"] == ("data", "model")
        assert fsdp["local_elems"] < n_params / 2
        _equal(fsdp["params"], rep["params"])
        _equal(fsdp["m"], rep["m"])
        _equal(fsdp["params"], ranks[0]["train"][(True, agg)]["params"])
        for a, b in zip(jax.tree_util.tree_leaves(fsdp["params"]),
                        [x.numpy() for x in tree_flatten(want_params)[0]]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(fsdp["m"]),
                        [x.numpy() for x in tree_flatten(want_opt.m)[0]]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(fsdp["losses"], np.float32), want_losses,
                                   rtol=1e-5, atol=1e-6)


def test_mesh_checkpoint_equals_one_rank_save(mesh_ranks, tmp_path):
    """The fsdp state saved from the mesh (gathered, rank 0 writes) equals,
    file array for file array, the same state saved whole from one
    process; restored on the mesh, every rank gets its blocks back bit for
    bit."""
    _, payload, ranks = mesh_ranks
    run = ranks[0]["train"][(True, "rfa")]
    whole = {"params": tree_map(torch.tensor, run["params"]),
             "opt_state": {"m": tree_map(torch.tensor, run["m"]),
                           "step": torch.tensor(run["blocks"][2])},
             "worker_m": {}}
    save_checkpoint(str(tmp_path), 3, whole)
    mine = np.load(os.path.join(tmp_path, "step_00000003", "arrays.npz"))
    theirs = np.load(os.path.join(payload["train"]["ckpt_dir"], "step_00000003", "arrays.npz"))
    assert sorted(mine.files) == sorted(theirs.files)
    for k in mine.files:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])
    for out in ranks:
        run = out["train"][(True, "rfa")]
        _equal(run["restored"], run["blocks"])


def _one_device_serve(batch):
    """The greedy loop through the port's and the reference's
    ``decode_step`` on one device: (port logits, port tokens, reference
    logits, reference tokens)."""
    rcfg, rp = _serve_params()
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), **SERVE_CFG)
    tp = params_from_jax(rp, "cpu")
    prompt = np.random.default_rng(5).integers(0, 512, (SERVE_B, PROMPT))[:batch]
    cache = tfm.init_cache(cfg, batch, CACHE, device="cpu")
    rcache = rtfm.init_cache(rcfg, batch, CACHE)
    logits_seq, toks, rlogits_seq, rtoks = [], [], [], []
    for pos in range(PROMPT + NEW):
        tok = torch.tensor(prompt[:, pos]) if pos < PROMPT else toks[-1]
        rtok = jnp.asarray(prompt[:, pos]) if pos < PROMPT else rtoks[-1]
        logits, cache = tfm.decode_step(tp, cfg, cache, tok, pos)
        rlogits, rcache = rtfm.decode_step(jax.tree_util.tree_map(jnp.asarray, rp), rcfg, rcache,
                                           rtok, jnp.asarray(pos, jnp.int32))
        logits_seq.append(logits.numpy())
        toks.append(torch.argmax(logits, -1))
        rlogits_seq.append(np.asarray(rlogits))
        rtoks.append(jnp.argmax(rlogits, -1))
    return (np.stack(logits_seq), np.stack([t.numpy() for t in toks]), np.stack(rlogits_seq),
            np.stack([np.asarray(t) for t in rtoks]))


def test_sharded_prefill(mesh_ranks):
    """Each rank prefills its own rows; gathered, the logits equal the
    one-device prefill's (rtol / atol 1e-5) and the reference's (1e-4)."""
    from repro.distributed.steps import make_prefill_step as r_make_prefill_step

    shape, payload, ranks = mesh_ranks
    rcfg, rp = _serve_params()
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), **SERVE_CFG)
    prompt = payload["serve"]["prompt"]
    want = make_prefill_step(cfg, device="cpu")(params_from_jax(rp, "cpu"),
                                                {"tokens": torch.tensor(prompt)}).numpy()
    rwant = np.asarray(r_make_prefill_step(rcfg, None)(
        jax.tree_util.tree_map(jnp.asarray, rp), {"tokens": jnp.asarray(prompt)}))
    rows = SERVE_B // shape[0]
    for r, out in enumerate(ranks):
        s = out["serve"]
        assert s["prefill_local"].shape == (rows, 1, cfg.vocab_size)
        d = r // shape[1]
        np.testing.assert_array_equal(s["prefill_local"], s["prefill"][d * rows:(d + 1) * rows])
        np.testing.assert_allclose(s["prefill"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["prefill"], rwant, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("label", ["batch", "sequence"])
def test_sharded_decode(mesh_ranks, label):
    """``make_serve_step``: a batch-sharded 4-row cache and a 1-row cache
    sequence-sharded over data (heads over model on 2x2), greedy from an
    8-token prompt for 6 new tokens over a 16-position cache. Every step's
    logits equal the one-device ``decode_step``'s within 1e-5 (the
    reference's within 1e-4) and the tokens are the same; each rank holds
    only its share of the cache."""
    shape, _, ranks = mesh_ranks
    B = SERVE_B if label == "batch" else 1
    logits, toks, rlogits, rtoks = _one_device_serve(B)
    np.testing.assert_array_equal(toks, rtoks)
    for out in ranks:
        s = out["serve"][label]
        np.testing.assert_allclose(s["logits"], logits, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["logits"], rlogits, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(s["tokens"], toks)
        if label == "sequence":
            assert s["specs"]["0"][2:4] == ("data", "model")  # model may be of size 1
        whole = 2 * 2 * B * CACHE * SERVE_CFG["n_kv_heads"] * 64  # k and v, 2 layers
        assert s["cache_elems"] == whole // 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_softmax_across_ranks(mesh_ranks, dtype):
    """The sequence-sharded decode's combine, each rank holding its
    positions and heads, against ``attention.softmax_values`` on the whole
    inputs: in fp32 within 1e-6; in bf16 it rounds where the one-device
    path does, so at most 1 % of the outputs differ, each by one bf16 step
    (rounding the partial sums too, or leaving the probabilities unrounded,
    moves 33-40 % of them, some by more)."""
    from repro_torch.models import attention as attn

    _, _, ranks = mesh_ranks
    logits, values = torch_shard_ranks.combine_inputs(dtype)
    want = attn.softmax_values(logits, values, dtype).float().numpy()
    for out in ranks:
        got = out["combine"][str(dtype)]
        np.testing.assert_array_equal(got, ranks[0]["combine"][str(dtype)])
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert np.all(np.abs(got - want) <= step)
            assert np.mean(got != want) <= 0.01


def test_sequence_sharded_decode_bf16(mesh_ranks):
    """The sequence-sharded decode in bf16 rounds where ``decode_attention``
    does (the probabilities to bf16, the values summed in fp32, one
    rounding): fed the same tokens, its logits are no further from the
    one-device fp32 steps' than 1.5 x the one-device bf16 steps' are, on
    every rank alike."""
    _, _, ranks = mesh_ranks
    _, rp = _serve_params()
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), **SERVE_CFG)
    feed = ranks[0]["serve"]["sequence_bf16"]["feed"]
    want = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
        p = tree_map(lambda t: t.to(dtype), params_from_jax(rp, "cpu"))
        cache = tfm.init_cache(c, 1, CACHE, device="cpu")
        steps = []
        for pos in range(feed.shape[1]):
            logits, cache = tfm.decode_step(p, c, cache, torch.as_tensor(feed[:, pos]), pos)
            steps.append(logits.float().numpy())
        want[dtype] = np.stack(steps)
    one_off = np.abs(want[torch.bfloat16] - want[torch.float32]).max()
    assert one_off > 0
    for out in ranks:
        got = out["serve"]["sequence_bf16"]["logits"]
        np.testing.assert_array_equal(got, ranks[0]["serve"]["sequence_bf16"]["logits"])
        assert np.abs(got - want[torch.float32]).max() <= 1.5 * one_off
