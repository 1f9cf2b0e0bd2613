"""The port's multi-rank engine (shard_kernels, packed_robust_sync over a
process group) held against the reference's single-device functions.

A gloo group of 4 ranks on the CPU, and one of 3 so that ``_pad_cols``
pads (the tree packs to 8192 columns, the stack has 1111), each started
once per module: the ranks run every case (``torch_shard_ranks.run_all``,
which imports no jax) and return their results; the parametrised tests
compare them. The reference's own multi-device test needs 8 forced host
devices and fails on this tree's jax, so its single-device functions are
the oracle, fed the same numpy inputs and, for the syncs, the reference's
mixing matrix.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from repro.core.aragg import RobustAggregator as RRobustAggregator
from repro.distributed.robust_sync import robust_gradient_sync as r_robust_gradient_sync
from repro.kernels import ops as rops
from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import packing
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.utils.tree import tree_flatten

W = 8
TAU = 3.0
RULES = [
    ("krum", {"n_byzantine": 2}),
    ("rfa", {}),
    ("cclip", {"tau": 3.0}),
    ("cm", {}),
    ("tm", {"n_trim": 2}),
    ("mean", {}),
]
MIXINGS = ["none", "bucketing", "resampling"]
CASES = [(agg, kwargs, mixing) for agg, kwargs in RULES for mixing in MIXINGS]
CASE_IDS = [f"{agg}-{mixing}" for agg, _, mixing in CASES]
ROUTE_SPECS = {"rfa": ("rfa", {}), "cclip": ("cclip", {"tau": 3.0}), "cm": ("cm", {}),
               "tm": ("tm", {"n_trim": 2}), "krum": ("krum", {"n_byzantine": 2}),
               "acclip": ("acclip", {})}


def _xs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tree():
    """Four leaves: 8192 packed columns, which 3 ranks do not divide."""
    shapes = {"w": (W, 16, 48), "b": (W, 33), "v": (W, 257), "u": (W, 3, 5)}
    return {k: _xs(s, seed=i + 1) for i, (k, s) in enumerate(shapes.items())}


@functools.lru_cache(maxsize=None)
def _mix(agg, mixing):
    kwargs = dict(next(kw for a, kw in RULES if a == agg))
    rra = RRobustAggregator.from_spec(agg, mixing=mixing, s=2, **kwargs)
    return rra, np.asarray(rra.mixing_matrix(jax.random.PRNGKey(11), W))


def _primitive_inputs():
    xs = _xs((W, 1111), seed=0)
    coeffs = np.asarray(jax.nn.softmax(jnp.arange(W, dtype=jnp.float32)))
    v0 = xs.mean(0)
    lam = np.minimum(1.0, TAU / np.sqrt(((xs - v0) ** 2).sum(1) + 1e-12)).astype(np.float32)
    mix = np.random.default_rng(1).standard_normal((5, W)).astype(np.float32)
    return dict(xs=xs, coeffs=coeffs, center=(coeffs @ xs).astype(np.float32), v0=v0,
                lam=lam, mix=mix, tau=TAU)


@pytest.fixture(scope="module", params=[4, 3], ids=["R4", "R3"])
def ranks(request):
    """Every rank's results, from one group of ``request.param`` ranks."""
    R = request.param
    payload = {
        "tree": _tree(),
        "primitives": _primitive_inputs(),
        "syncs": {f"{agg}-{mixing}": (agg, kwargs, mixing, _mix(agg, mixing)[1])
                  for agg, kwargs, mixing in CASES},
        "routes": ROUTE_SPECS,
    }
    results = spawn_ranks(torch_shard_ranks.run_all, R, backend="gloo",
                          devices=["cpu"] * R, args=(payload,), timeout_s=600)
    assert [r["rank"] for r in results] == list(range(R))
    assert all(r["world_size"] == R for r in results)
    return results


@functools.lru_cache(maxsize=None)
def _reference_sync(agg, mixing):
    rra, _ = _mix(agg, mixing)
    tree = {k: jnp.asarray(v) for k, v in _tree().items()}
    out, _ = r_robust_gradient_sync(tree, rra, key=jax.random.PRNGKey(11), mesh=None)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _per_leaf_oracle(agg, mixing):
    """The port's single-device per-leaf engine (kernel route)."""
    kwargs = dict(next(kw for a, kw in RULES if a == agg))
    ra = RobustAggregator.from_spec(agg, mixing=mixing, s=2, **kwargs)
    tree = {k: torch.tensor(v) for k, v in _tree().items()}
    out, _ = robust_gradient_sync(tree, ra, mix=torch.tensor(_mix(agg, mixing)[1]),
                                  engine="per_leaf", use_kernels=True)
    return {k: v.numpy() for k, v in out.items()}


# ------------------------------------------------------- sharded primitives
def _reference_primitives():
    p = _primitive_inputs()
    xs = jnp.asarray(p["xs"])
    v_ref, r2_ref = rops.cclip_iter(xs, jnp.asarray(p["v0"]), jnp.asarray(p["lam"]))
    return {
        "gram": (rops.gram(xs), dict(rtol=1e-5, atol=1e-5)),
        "mix": (rops.mix_apply(jnp.asarray(p["mix"]), xs), dict(rtol=1e-5, atol=1e-5)),
        "cm": (rops.cm_aggregate(xs), None),
        "tm": (rops.tm_aggregate(xs, 2), None),
        "cw": (xs.sum(0), dict(rtol=1e-6, atol=1e-6)),
        "norms_c": (rops.norms(xs, jnp.asarray(p["coeffs"])), dict(rtol=1e-4, atol=1e-4)),
        "norms_v": (rops.norms(xs, center=jnp.asarray(p["center"])),
                    dict(rtol=1e-4, atol=1e-4)),
        "cclip_v": (v_ref, dict(rtol=1e-5, atol=1e-5)),
        "cclip_r2": (r2_ref, dict(rtol=1e-4, atol=1e-4)),
        "rfa": (rops.rfa_aggregate(xs), dict(rtol=1e-4, atol=1e-4)),
        "cclip": (rops.cclip_aggregate(xs, TAU), dict(rtol=1e-4, atol=1e-4)),
    }


PRIMITIVES = ["gram", "mix", "cm", "tm", "cw", "norms_c", "norms_v", "cclip_v", "cclip_r2",
              "rfa", "cclip"]


@pytest.fixture(scope="module")
def reference_primitives():
    return _reference_primitives()


@pytest.mark.parametrize("name", PRIMITIVES)
def test_sharded_primitive_matches_single_device(ranks, reference_primitives, name):
    """Each rank's sharded primitive against the reference's single-device
    kernel function, at tests/test_shard_engine.py's tolerances; the
    column-local selection kernels (CM, TM) bit for bit."""
    want, tol = reference_primitives[name]
    for r in ranks:
        got = r["primitives"][name]
        if tol is None:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_pad_cols_pads_to_equal_slices(ranks):
    R = len(ranks)
    n_local = {r["primitives"]["n_local"] for r in ranks}
    assert n_local == {-(-1111 // R)}


# ---------------------------------------------------- robust_gradient_sync
@pytest.mark.parametrize("agg,kwargs,mixing", CASES, ids=CASE_IDS)
def test_sync_over_group_matches_reference(ranks, agg, kwargs, mixing):
    """The packed engine over the group, on every rank, against the
    reference's ``robust_gradient_sync(mesh=None)`` with the same mixing
    matrix (rtol/atol 5e-4, as tests/test_shard_engine.py)."""
    want = _reference_sync(agg, mixing)
    for r in ranks:
        got = r["syncs"][f"{agg}-{mixing}"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("agg,kwargs,mixing", CASES, ids=CASE_IDS)
def test_every_rank_gets_the_same_result(ranks, agg, kwargs, mixing):
    first = ranks[0]["syncs"][f"{agg}-{mixing}"]
    for r in ranks[1:]:
        for k, v in r["syncs"][f"{agg}-{mixing}"].items():
            np.testing.assert_array_equal(v, first[k])


@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("agg", ["cm", "tm"])
def test_sharded_cm_tm_bit_match_per_leaf_oracle(ranks, agg, mixing):
    """CM and TM are column-local through the same selection programs, so
    the group's result equals the one-device per-leaf engine bit for bit."""
    want = _per_leaf_oracle(agg, mixing)
    for r in ranks:
        for k, v in r["syncs"][f"{agg}-{mixing}"].items():
            np.testing.assert_array_equal(v, want[k])


def test_no_silent_fallback_over_a_group(ranks):
    """RFA and CCLIP take the fused compositions and no Gram; CM and TM
    the sharded selection kernels; Krum and ACClip the sharded Gram and
    combine (the Gram route mixes in Gram space, not on the buffer)."""
    for r in ranks:
        h = r["routes"]
        assert h["rfa"] == {"mix_apply": 2, "rfa_aggregate": 1, "residual_norms": 8}, h
        assert h["cclip"] == {"mix_apply": 2, "cclip_aggregate": 1, "residual_norms": 1,
                              "cclip_fused_iter": 3}, h
        assert h["cm"] == {"mix_apply": 1, "cm_aggregate": 1}, h
        assert h["tm"] == {"mix_apply": 1, "tm_aggregate": 1}, h
        assert h["krum"] == {"gram": 1, "mix_apply": 1}, h
        assert h["acclip"] == {"gram": 1, "mix_apply": 1}, h


# ------------------------------------------------- one device, no group
@pytest.mark.parametrize("agg,kwargs,mixing", CASES, ids=CASE_IDS)
def test_per_leaf_engine_bit_matches_packed(agg, kwargs, mixing):
    """On one device the per-leaf engine (kernel route, Gram chained through
    ``acc``) equals the packed engine bit for bit."""
    ra = RobustAggregator.from_spec(agg, mixing=mixing, s=2, **kwargs)
    tree = {k: torch.tensor(v) for k, v in _tree().items()}
    mix = torch.tensor(_mix(agg, mixing)[1])
    packed, _ = robust_gradient_sync(tree, ra, mix=mix)
    want = _per_leaf_oracle(agg, mixing)
    for k in tree:
        np.testing.assert_array_equal(packed[k].numpy(), want[k])
    plain, _ = robust_gradient_sync(tree, ra, mix=mix, engine="per_leaf")
    for k in tree:
        np.testing.assert_allclose(plain[k].numpy(), want[k], rtol=5e-4, atol=5e-4)


def test_what_is_not_ported_raises():
    """What the engines still refuse: an unknown engine, a mesh that is no
    process group, worker-sharded rows in the per-leaf engine. Placements
    without a mesh are ignored (the reference's egress needs a mesh), by
    either engine."""
    ra = RobustAggregator.from_spec("rfa", mixing="none")
    tree = {"a": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    for engine in ("packed", "per_leaf"):
        plain, _ = robust_gradient_sync(tree, ra, engine=engine)
        placed, _ = robust_gradient_sync(tree, ra, engine=engine, out_shardings={"a": None})
        assert torch.equal(plain["a"], placed["a"])
    with pytest.raises(NotImplementedError, match="packed engine"):
        robust_gradient_sync(tree, ra, engine="per_leaf", worker_sharded=True)
    with pytest.raises(ValueError):
        robust_gradient_sync(tree, ra, engine="nope")
    with pytest.raises(TypeError):
        robust_gradient_sync(tree, ra, mesh=object(), engine="per_leaf")


# ------------------------------------------- the worker-sharded train step
TRAIN_W, TRAIN_STEPS = 4, 3
TRAIN_CFG = {"n_layers": 1, "d_model": 64, "n_heads": 2, "n_kv_heads": 2, "d_ff": 128,
             "vocab_size": 128}


def _train_payload():
    rng = np.random.default_rng(21)
    toks = rng.integers(0, TRAIN_CFG["vocab_size"], (2 * TRAIN_W, 17))
    mixes = {agg: [np.asarray(RRobustAggregator.from_spec(agg, mixing="bucketing", s=2)
                              .mixing_matrix(jax.random.PRNGKey(30 + t), TRAIN_W))
                   for t in range(TRAIN_STEPS)] for agg in ("rfa", "cm")}
    return {"stack": _xs((TRAIN_W, 6001), seed=22), "cfg": TRAIN_CFG, "lr": 0.05,
            "batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
            "runs": {agg: (agg, m) for agg, m in mixes.items()}}


@pytest.fixture(scope="module", params=[2, 4], ids=["R2", "R4"])
def train_ranks(request):
    """Every rank's results of ``torch_shard_ranks.run_train``."""
    R = request.param
    return spawn_ranks(torch_shard_ranks.run_train, R, backend="gloo", devices=["cpu"] * R,
                       args=(_train_payload(),), timeout_s=600)


@functools.lru_cache(maxsize=None)
def _one_device_train(agg):
    """The same steps by ``make_train_step`` on one device."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step

    p = _train_payload()
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **p["cfg"])
    step_fn, state = make_train_step(cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2),
                                     lr=p["lr"], n_workers=TRAIN_W, device="cpu")
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    batch = {k: torch.tensor(v) for k, v in p["batch"].items()}
    losses = []
    for mix in p["runs"][agg][1]:
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m,
                                                       torch.tensor(mix), batch)
        losses.append(float(metrics["loss"]))
    return params, losses


def test_worker_sharded_ingress_equals_shard_cols(train_ranks):
    """One all_to_all of each rank's worker rows gives the column slice
    that ``shard_cols`` cuts from the global stack, bit for bit."""
    for r in train_ranks:
        assert r["ingress"].shape == r["shard_cols"].shape
        np.testing.assert_array_equal(r["ingress"], r["shard_cols"])


@pytest.mark.parametrize("agg", ["rfa", "cm"])
def test_worker_sharded_train_step(train_ranks, agg):
    """Each rank runs its own workers; after three steps every rank holds
    rank 0's parameters bit for bit, and they agree with the one-device
    step within rtol 1e-4 / atol 1e-6 (RFA's group route runs Weiszfeld in
    vector space, the one-device route in Gram space); the losses are the
    mean over all workers. RFA goes through the sharded residual norms."""
    R = len(train_ranks)
    first = train_ranks[0]["runs"][agg]
    want_params, want_losses = _one_device_train(agg)
    want = [v.numpy() for v in tree_flatten(want_params)[0]]
    for rank, r in enumerate(train_ranks):
        run = r["runs"][agg]
        assert tuple(run["workers"]) == (rank * TRAIN_W // R, (rank + 1) * TRAIN_W // R)
        for a, b in zip(jax.tree_util.tree_leaves(run["params"]),
                        jax.tree_util.tree_leaves(first["params"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(np.asarray(run["losses"], np.float32), want_losses,
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(run["params"]), want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        want_route = ({"mix_apply": 2, "rfa_aggregate": 1, "residual_norms": 8} if agg == "rfa"
                      else {"mix_apply": 1, "cm_aggregate": 1})
        assert run["routes"] == {k: v * TRAIN_STEPS for k, v in want_route.items()}


def test_a_failing_rank_fails_the_group():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one fails"):
        spawn_ranks(torch_shard_ranks.fail_on_rank_one, 2, backend="gloo",
                    devices=["cpu", "cpu"], timeout_s=120)
    assert time.monotonic() - t0 < 60  # the hung rank was stopped, not waited for
