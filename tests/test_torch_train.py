"""The port's LLM training path held against the JAX reference on the CPU.

Tree utilities, optimizers and schedules on random numpy trees; the
gradients of ``transformer.loss_fn`` against ``jax.grad``; one
``make_train_step`` step against a reference step built by hand; the
synthetic token stream on the reference's draws; the loss-decrease gate of
``tests/test_system.py``.

The reference's own train step fails on any mesh under this tree's jax
(``tests/test_steps.py``), so the oracle step is assembled from the pieces
that run on the CPU, in the order of ``repro/distributed/steps.py``:
``jax.vmap(jax.value_and_grad(loss_fn))`` over the workers, the
worker-momentum update, ``robust_gradient_sync(..., mesh=None)`` fed the
round's key (its mixing matrix goes to the port as ``mix``), and
``make_optimizer``'s update. The reference sync runs its plain jnp route,
CM and TM their kernels in interpret mode (bit-exact selection).

Tolerances: tree arithmetic, SGD-M (fp32 and bf16 momentum storage) and
the token stream bit for bit; AdamW within 1 ulp (XLA's CPU build and
torch round ``pow`` / ``sqrt`` / the division chain differently in a few
elements); schedules within 1 ulp; ``loss_fn`` gradients in fp32 at rtol
1e-4 / atol 1e-5 on every leaf, in bf16 at rtol and atol 2e-2 against the
leaf's largest entry (the two packages sum bf16 products in other orders
and round each op's output to bf16); one train step in fp32 at rtol 1e-4 /
atol 1e-6 on the momenta, the optimizer state, the loss and SGD-M's
parameter update, AdamW's update at rtol 1e-4 / atol 2e-3 lr (its
per-entry normalisation; ``test_train_step_matches_reference``), Kimi K2's
bf16 optimizer momentum and its update at one bf16 step (rtol 2^-7).
The MoE configs (OLMoE, Kimi K2) go through the same gradients and steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from repro import configs as rconfigs
from repro.configs.base import ByzConfig as RByzConfig
from repro.data import synthetic as rsynthetic
from repro.distributed.robust_sync import robust_gradient_sync as r_robust_gradient_sync
from repro.distributed.steps import input_specs as r_input_specs
from repro.models import transformer as rtfm
from repro.optim import make_optimizer as r_make_optimizer
from repro.optim import schedule as rschedule
from repro.utils import tree as rtree
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, ByzConfig, InputShape
from repro_torch.convert import opt_state_from_jax, params_from_jax, worker_m_from_jax
from repro_torch.data import synthetic
from repro_torch.distributed.steps import input_specs, make_train_step
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer, schedule
from repro_torch.utils import tree
from repro_torch.utils.tree import tree_flatten

ARCHS = ["gemma-7b", "qwen2.5-14b", "tinyllama-1.1b"]
MOE_ARCHS = ["kimi-k2-1t-a32b", "olmoe-1b-7b"]
W = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    x = x.detach()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _leaves_np(t):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(t)]


def _rand_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (37, 5), "b": {"c": (129,), "d": (3, 4, 5)}, "e": [(7,), (2, 2)]}
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _carry(tree_np):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree_np), device="cpu")


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64)), initial=0))


def _assert_trees(got, want, max_ulp=0):
    g = [_np(x) for x in tree_flatten(got)[0]]
    w = _leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        assert _ulps(a, b) <= max_ulp


# --------------------------------------------------------------- tree utils
@pytest.mark.parametrize("fn", ["tree_zeros_like", "tree_add", "tree_sub", "tree_scale",
                                "tree_axpy", "tree_stack_flat", "tree_unstack_flat"])
def test_tree_arithmetic_bit_for_bit(fn):
    a, b = _rand_tree(1), _rand_tree(2)
    ja = jax.tree_util.tree_map(jnp.asarray, a)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    ta, tb = _carry(a), _carry(b)
    args = {"tree_zeros_like": ((ja,), (ta,)), "tree_add": ((ja, jb), (ta, tb)),
            "tree_sub": ((ja, jb), (ta, tb)), "tree_scale": ((ja, 0.37), (ta, 0.37)),
            "tree_axpy": ((-1.3, ja, jb), (-1.3, ta, tb))}
    if fn == "tree_stack_flat":
        want, unflat = rtree.tree_stack_flat(ja)
        got, t_unflat = tree.tree_stack_flat(ta)
        assert np.array_equal(_np(got), np.asarray(want))
        _assert_trees(t_unflat(got * 2), unflat(want * 2))
        return
    if fn == "tree_unstack_flat":
        vec = np.arange(tree.tree_size(ta), dtype=np.float32)
        _assert_trees(tree.tree_unstack_flat(torch.tensor(vec), ta),
                      rtree.tree_unstack_flat(jnp.asarray(vec), ja))
        return
    rargs, targs = args[fn]
    _assert_trees(getattr(tree, fn)(*targs), getattr(rtree, fn)(*rargs))


def test_tree_reductions_in_fp32():
    a, b = _rand_tree(3), _rand_tree(4)
    ja = jax.tree_util.tree_map(jnp.asarray, a)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    ta, tb = _carry(a), _carry(b)
    assert tree.tree_size(ta) == rtree.tree_size(ja) == 37 * 5 + 129 + 60 + 7 + 4
    np.testing.assert_allclose(float(tree.tree_dot(ta, tb)), float(rtree.tree_dot(ja, jb)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tree.tree_global_norm(ta)),
                               float(rtree.tree_global_norm(ja)), rtol=1e-6)
    # bf16 leaves accumulate in fp32
    half = tree.tree_scale(ta, 1.0)
    half["a"] = half["a"].to(torch.bfloat16)
    ref = jax.tree_util.tree_map(jnp.asarray, a)
    ref["a"] = ref["a"].astype(jnp.bfloat16)
    assert tree.tree_global_norm(half).dtype == torch.float32
    np.testing.assert_allclose(float(tree.tree_global_norm(half)),
                               float(rtree.tree_global_norm(ref)), rtol=1e-6)


def test_tree_walks_leave_no_reference_cycle():
    """Flattening and rebuilding a tree frees its leaves as soon as the
    last reference goes, without the cyclic collector: a cycle would hold
    a full-width model's momenta (tens of GB) until the collector ran."""
    import gc
    import weakref

    gc.disable()
    try:
        leaf = torch.zeros(8)
        ref = weakref.ref(leaf)
        leaves, treedef = tree_flatten({"a": [leaf, (leaf,)], "b": {"c": leaf}})
        rebuilt = tree.tree_unflatten(treedef, leaves)
        mapped = tree.tree_map(lambda x: x, rebuilt)
        del leaf, leaves, treedef, rebuilt, mapped
        assert ref() is None
    finally:
        gc.enable()


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name,hp,max_ulp", [
    ("sgdm", {}, 0),
    ("sgdm", {"weight_decay": 0.1}, 0),
    ("sgd", {}, 0),
    ("sgdm", {"m_dtype": "bfloat16"}, 0),
    ("adamw", {}, 1),
    ("adamw", {"weight_decay": 0.1}, 1),
], ids=["sgdm", "sgdm-wd", "sgd", "sgdm-bf16-m", "adamw", "adamw-wd"])
def test_optimizer_steps_match(name, hp, max_ulp):
    """Five steps from the same parameters and gradients: parameters and
    every moment bit for bit (SGD-M) or within 1 ulp (AdamW)."""
    p = _rand_tree(5)
    r_init, r_update = r_make_optimizer(name, lr=0.05, **hp)
    init, update = make_optimizer(name, lr=0.05, **hp)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    rs = r_init(rp)
    tp = _carry(p)
    ts = init(tp)
    for t in range(5):
        g = _rand_tree(10 + t, scale=0.3)
        rp, rs = r_update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        tp, ts = update(_carry(g), ts, tp)
    _assert_trees(tp, rp, max_ulp)
    _assert_trees(ts.m, rs.m, 0)
    assert ts.m["a"].dtype == getattr(torch, hp.get("m_dtype", "float32"))
    if rs.v is None:
        assert ts.v is None
    else:
        _assert_trees(ts.v, rs.v, 0)
    assert int(ts.step) == int(rs.step) == 5 and ts.step.dtype == torch.int32


def test_optimizer_state_carries_across():
    """A reference state, carried by ``opt_state_from_jax``, continues as the
    reference continues."""
    p, g = _rand_tree(6), _rand_tree(7, scale=0.3)
    r_init, r_update = r_make_optimizer("adamw", lr=0.01)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    rs = r_init(rp)
    rp, rs = r_update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, rs), device="cpu")
    tp = _carry(rp)
    rp, rs = r_update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
    tp, ts = make_optimizer("adamw", lr=0.01)[1](_carry(g), ts, tp)
    _assert_trees(tp, rp, 1)
    assert int(ts.step) == 2


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match(name):
    make = {"constant": lambda m: m.constant_lr(0.3),
            "cosine": lambda m: m.cosine_lr(0.3, 50, 0.2),
            "warmup_cosine": lambda m: m.warmup_cosine_lr(0.3, 60, 10, 0.1)}[name]
    ours, theirs = make(schedule), make(rschedule)
    for step in (0, 1, 5, 9, 10, 11, 30, 59, 60, 75):
        got, want = ours(step), theirs(step)
        assert got.dtype == torch.float32
        assert _ulps(_np(got), np.asarray(want)) <= 1, (step, float(got), float(want))


# ------------------------------------------------------------- input specs
def test_input_specs_match():
    for arch in ARCHS + MOE_ARCHS:
        cfg, rcfg = configs.smoke_config(arch), rconfigs.smoke_config(arch)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            mine = input_specs(cfg, INPUT_SHAPES[shape])
            theirs = r_input_specs(rcfg, rconfigs.INPUT_SHAPES[shape])
            assert sorted(mine) == sorted(theirs)
            for k in mine:
                assert mine[k].shape == theirs[k].shape
                assert str(mine[k].dtype).split(".")[-1] == theirs[k].dtype.name


# --------------------------------------------------------- loss_fn gradients
def _batch(cfg, B, S, seed, ignore=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if ignore:
        labels[:, :ignore] = -100
        labels[0, -1] = -100
    return {"tokens": toks[:, :-1], "labels": labels}


def _grads_both(arch, dtype="float32", B=2, S=32, ignore=3, **kw):
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=dtype, **kw)
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), dtype=dtype, **kw)
    rp = rtfm.init_params(rcfg, jax.random.PRNGKey(1))
    batch = _batch(cfg, B, S, seed=2, ignore=ignore)
    (rloss, _), rg = jax.value_and_grad(rtfm.loss_fn, has_aux=True)(
        rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _carry(rp)
    leaves, _ = tree_flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tfm.loss_fn(tp, cfg, {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), grads), (rloss, jax.tree_util.tree_leaves(rg))


@pytest.mark.parametrize("impl", ["xla", "blockwise"])
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_loss_fn_gradients_fp32(arch, impl):
    """Every leaf's gradient against ``jax.grad`` in fp32; -100 labels in
    the batch; blockwise with 16-wide blocks at S = 32. For the MoE archs
    the loss carries the router losses, and the router's gradient flows
    through the gates, the load balance and the z-loss."""
    (loss, grads), (rloss, rgrads) = _grads_both(
        arch, attention_impl=impl, attn_block_q=16, attn_block_kv=16)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert len(grads) == len(rgrads)
    for g, rg in zip(grads, rgrads):
        assert g.shape == rg.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(rg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "blockwise"])
def test_loss_fn_gradients_sliding_window(impl):
    (loss, grads), (rloss, rgrads) = _grads_both(
        "tinyllama-1.1b", sliding_window=8, attention_impl=impl, attn_block_q=16,
        attn_block_kv=16)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(_np(g), np.asarray(rg), rtol=1e-4, atol=1e-5)


def test_loss_fn_ignores_masked_labels():
    """All labels -100 but one: the loss is that one position's NLL and
    gradients flow from it alone, as in the reference. All of them -100:
    loss 0 and zero gradients in both."""
    (loss, grads), (rloss, rgrads) = _grads_both("tinyllama-1.1b", B=1, S=32, ignore=30)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(_np(g), np.asarray(rg), rtol=1e-4, atol=1e-5)
    assert float(loss) > 0
    (loss, grads), (rloss, rgrads) = _grads_both("tinyllama-1.1b", B=1, S=32, ignore=31)
    assert float(loss) == float(rloss) == 0.0
    assert all(not g.any() for g in grads) and not any(np.asarray(g).any() for g in rgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_bf16(arch):
    """bf16 parameters: bf16 gradients within 2e-2 of the leaf's largest
    entry, loss within 2e-2."""
    (loss, grads), (rloss, rgrads) = _grads_both(arch, dtype="bfloat16")
    np.testing.assert_allclose(float(loss), float(rloss), rtol=2e-2)
    for g, rg in zip(grads, rgrads):
        assert g.dtype == torch.bfloat16
        want = np.asarray(rg, np.float32)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(g) / scale, want / scale, rtol=2e-2, atol=2e-2)


# ------------------------------------------------------- one train step
S_STEP, B_STEP, LR_STEP = 16, 2 * W, 0.05
TINY = "tinyllama-1.1b"
STEP_CASES = (
    [(agg, mixing, "worker", "sgdm", 0.9, TINY)
     for agg in ("mean", "rfa", "krum", "cm", "tm", "cclip") for mixing in ("none", "bucketing")]
    + [(agg, mixing, "server", "adamw", 0.9, TINY)
       for agg in ("mean", "rfa", "krum", "cm", "tm", "cclip") for mixing in ("none", "bucketing")]
    + [("rfa", "bucketing", "worker", "adamw", 0.9, TINY),
       ("rfa", "bucketing", "server", "sgdm", 0.9, TINY),
       ("mean", "none", "worker", "sgdm", 0.0, TINY)]
    # the MoE family: OLMoE with worker momentum; Kimi K2 as its config
    # trains, with server momentum, fsdp (on one rank) and bf16 momentum
    + [("rfa", "bucketing", "worker", "sgdm", 0.9, "olmoe-1b-7b"),
       ("cm", "bucketing", "worker", "sgdm", 0.9, "olmoe-1b-7b"),
       ("rfa", "bucketing", "server", "sgdm", 0.9, "kimi-k2-1t-a32b"),
       ("cm", "bucketing", "server", "sgdm", 0.9, "kimi-k2-1t-a32b")])
STEP_IDS = [("" if arch == TINY else arch.split("-")[0] + "-")
            + f"{a}-{m}-{mode}-{opt}" + ("-no_wm" if beta == 0 else "")
            for a, m, mode, opt, beta, arch in STEP_CASES]


@functools.lru_cache(maxsize=None)
def _step_start(arch=TINY):
    """The step's inputs as numpy: parameters, a batch, non-zero worker
    momenta, and optimizer moments as the reference's AdamW leaves them
    after three steps on random gradients (a state whose second moment
    matches its first, as a run's does), so every carried state is
    exercised. The first moment is stored in the config's
    ``opt_m_dtype`` (bf16 for Kimi K2), as its optimizer keeps it."""
    rcfg = rconfigs.smoke_config(arch)
    params = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    batch = _batch(rcfg, B_STEP, S_STEP, seed=3, ignore=2)
    rng = np.random.default_rng(4)
    small = lambda p, lead=(): (rng.standard_normal(lead + p.shape) * 1e-3).astype(np.float32)  # noqa: E731
    worker_m = jax.tree_util.tree_map(lambda p: small(p, (W,)), params)
    init, update = r_make_optimizer("adamw", lr=LR_STEP)
    state = init(params)
    for _ in range(3):
        _, state = update(jax.tree_util.tree_map(small, params), state, params)
    params = jax.tree_util.tree_map(np.asarray, params)
    m, v = (jax.tree_util.tree_map(np.asarray, t) for t in (state.m, state.v))
    m = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x).astype(rcfg.opt_m_dtype)), m)
    return params, batch, worker_m, m, v


@functools.lru_cache(maxsize=None)
def _reference_worker_grads(arch=TINY):
    """``jax.vmap(jax.value_and_grad(loss_fn))`` over the workers, and the
    plain-mean baseline's gradient of the mean loss."""
    rcfg = rconfigs.smoke_config(arch)
    params, batch, *_ = _step_start(arch)
    wbatch = {k: jnp.asarray(v).reshape((W, -1) + v.shape[1:]) for k, v in batch.items()}

    def one_worker(p, b):
        (loss, _), g = jax.value_and_grad(rtfm.loss_fn, has_aux=True)(p, rcfg, b)
        return g, loss

    grads_w, losses = jax.jit(jax.vmap(one_worker, in_axes=(None, 0)))(params, wbatch)

    def mean_loss(p):
        loss, aux = jax.vmap(lambda b: rtfm.loss_fn(p, rcfg, b))(wbatch)
        return jnp.mean(loss), aux

    (mloss, _), mgrads = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(params)
    return (grads_w, losses), (mgrads, mloss)


def _opt_start(optimizer, m, v):
    step = np.asarray(3, np.int32)
    return (step, m, v if optimizer == "adamw" else None)


def _reference_step(agg, mixing, mode, optimizer, beta, key, arch=TINY):
    """The reference's train step, assembled in the order of
    ``repro/distributed/steps.py`` (module docstring). On one device the
    reference's fsdp egress places every leaf whole: the same step."""
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), momentum_mode=mode)
    rbyz = RByzConfig(aggregator=agg, mixing=mixing, s=2, worker_momentum=beta)
    aggregator = rbyz.make_aggregator(W)
    params, _, worker_m, m, v = _step_start(arch)
    _, opt_update = r_make_optimizer(optimizer, lr=LR_STEP, beta1=beta or 0.9,
                                     m_dtype=rcfg.opt_m_dtype)
    from repro.optim import OptState as ROptState
    step, m0, v0 = _opt_start(optimizer, m, v)
    opt_state = ROptState(jnp.asarray(step), m0, v0)
    use_worker_momentum = mode == "worker" and beta > 0
    (grads_w, losses), (mgrads, mloss) = _reference_worker_grads(arch)
    if agg == "mean" and mixing == "none" and not use_worker_momentum:
        loss, agg_grads = mloss, mgrads
    else:
        loss = jnp.mean(losses)
        if use_worker_momentum:
            worker_m = jax.tree_util.tree_map(
                lambda mi, g: beta * mi + (1.0 - beta) * g.astype(jnp.float32), worker_m, grads_w)
            messages = worker_m
        else:
            messages = grads_w
            worker_m = {}
        agg_grads, _ = r_robust_gradient_sync(messages, aggregator, key=key, mesh=None,
                                              engine="packed", use_kernels=agg in ("cm", "tm"))
    if not use_worker_momentum:
        worker_m = {}
    params, opt_state = opt_update(agg_grads, opt_state, jax.tree_util.tree_map(
        jnp.asarray, params))
    return params, opt_state, worker_m, loss, np.asarray(aggregator.mixing_matrix(key, W))


def _port_step(agg, mixing, mode, optimizer, beta, mix, telemetry=False, arch=TINY, **kw):
    cfg = dataclasses.replace(configs.smoke_config(arch), momentum_mode=mode, **kw)
    byz = ByzConfig(aggregator=agg, mixing=mixing, s=2, worker_momentum=beta)
    step_fn, state = make_train_step(cfg, byz, lr=LR_STEP, optimizer=optimizer,
                                     telemetry=telemetry, n_workers=W, device="cpu")
    params, batch, worker_m, m, v = _step_start(arch)
    use_worker_momentum = mode == "worker" and beta > 0
    assert bool(state["worker_m"]) == use_worker_momentum
    wm = worker_m_from_jax(worker_m if use_worker_momentum else {}, device="cpu")
    out = step_fn(params_from_jax(params, device="cpu"),
                  opt_state_from_jax(_opt_start(optimizer, m, v), device="cpu"), wm,
                  torch.tensor(mix), {k: torch.tensor(x) for k, x in batch.items()})
    return out


@pytest.mark.parametrize("agg,mixing,mode,optimizer,beta,arch", STEP_CASES, ids=STEP_IDS)
def test_train_step_matches_reference(agg, mixing, mode, optimizer, beta, arch):
    """One step from the same state: the worker momenta, the optimizer's
    moments and the loss within rtol 1e-4 / atol 1e-6, and so is the
    parameters' update ``p' - p`` under SGD-M. AdamW divides each entry by
    its own second moment, so its update is O(lr) for every entry, however
    small the gradient there: the two packages' gradients agree to ~1.6e-6
    of each leaf's largest entry, which leaves ~1 % of the entries beyond
    rtol 1e-4 of themselves, and AdamW's update carries those relative
    errors at the scale of lr (the worst entry measured: 8.2e-4 lr, in 1
    to 6 entries of 1.57 M). Its update is held at rtol 1e-4 with atol
    2e-3 lr; its moments, which it is computed from, at the common bar.

    Kimi K2 stores SGD-M's momentum in bf16 (``opt_m_dtype``): each entry
    of m' = bf16(beta m + g) is rounded once to 8 significant bits, so an
    fp32 difference in g far below 1e-4 can move it across a rounding
    boundary, one bf16 step: at most 2^-7 of itself. Its momentum and the
    update lr m' are held at rtol 2^-7 (one bf16 step) with the common
    atol; the loss, at the common bar. OLMoE's and TinyLlama's cases are
    fp32 throughout."""
    key = jax.random.PRNGKey(5)
    rparams, ropt, rwm, rloss, mix = _reference_step(agg, mixing, mode, optimizer, beta, key,
                                                     arch)
    params, opt_state, worker_m, metrics = _port_step(agg, mixing, mode, optimizer, beta, mix,
                                                      arch=arch)
    close = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]), float(rloss), **close)
    p0 = _leaves_np(_step_start(arch)[0])
    bf16_m = rconfigs.smoke_config(arch).opt_m_dtype == "bfloat16"
    m_close = dict(rtol=2.0 ** -7, atol=1e-6) if bf16_m else close
    update = dict(rtol=1e-4, atol=2e-3 * LR_STEP) if optimizer == "adamw" else m_close
    for a, b, p in zip(tree_flatten(params)[0], _leaves_np(rparams), p0):
        np.testing.assert_allclose(_np(a).astype(np.float64) - p, b.astype(np.float64) - p,
                                   **update)
    trees = [(opt_state.m, ropt.m, m_close), (worker_m, rwm, close)]
    if ropt.v is not None:
        trees.append((opt_state.v, ropt.v, close))
    for got, want, tol in trees:
        g, w = tree_flatten(got)[0], _leaves_np(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(_np(a), b, **tol)
    m_dtype = {x.dtype for x in tree_flatten(opt_state.m)[0]}
    assert m_dtype == {torch.bfloat16 if bf16_m else torch.float32}
    assert int(opt_state.step) == int(ropt.step) == 4


@pytest.mark.parametrize("agg", ["rfa", "cm", "krum"])
def test_train_step_telemetry_changes_no_bit(agg):
    """Telemetry on leaves parameters, momenta and loss bit for bit as off,
    and adds the sync's metrics."""
    mix = np.asarray(RByzConfig(aggregator=agg, mixing="bucketing", s=2)
                     .make_aggregator(W).mixing_matrix(jax.random.PRNGKey(6), W))
    off = _port_step(agg, "bucketing", "worker", "sgdm", 0.9, mix)
    on = _port_step(agg, "bucketing", "worker", "sgdm", 0.9, mix, telemetry=True)
    for a, b in zip(*(tree_flatten((r[0], r[1].m, r[2]))[0] for r in (off, on))):
        assert torch.equal(a, b)
    assert torch.equal(off[3]["loss"], on[3]["loss"])
    assert "telemetry" not in off[3] and on[3]["telemetry"]["sync_n_workers"] == W


def test_train_step_rejects_fsdp_and_uneven_workers():
    """On one rank an fsdp config trains: the reference's param-sharded
    egress places every leaf whole there, so its step is the replicated
    one, bit for bit. Over 2 gloo ranks fsdp still raises (the egress over
    ranks is not ported), and so do 3 workers over 2 ranks."""
    mix = np.asarray(RByzConfig(aggregator="rfa", mixing="bucketing", s=2)
                     .make_aggregator(W).mixing_matrix(jax.random.PRNGKey(6), W))
    steps = [_port_step("rfa", "bucketing", mode, "sgdm", 0.9, mix, fsdp=fsdp)
             for mode in ("worker", "server") for fsdp in (False, True)]
    for plain, fsdp in (steps[:2], steps[2:]):
        for a, b in zip(*(tree_flatten((r[0], r[1].m, r[2], r[3]["loss"]))[0]
                          for r in (plain, fsdp))):
            assert torch.equal(a, b)
    refusals = spawn_ranks(torch_shard_ranks.train_step_refusals, 2, backend="gloo",
                           devices=["cpu", "cpu"], timeout_s=300)
    for r in refusals:
        assert r["fsdp"].startswith("NotImplementedError") and "ROADMAP" in r["fsdp"]
        assert r["uneven"].startswith("ValueError") and "3 workers" in r["uneven"]


# ------------------------------------------------------------ token stream
def _reference_draws(key, n_workers, seq_len, n_seqs, vocab, heterogeneous, noise_p):
    """The draws ``repro.data.synthetic.make_token_stream`` makes from ``key``."""
    k_ab, k_init, k_noise, k_unif = jax.random.split(key, 4)
    n_laws = n_workers if heterogeneous else 1
    shape = (n_workers, n_seqs)
    return synthetic.TokenDraws(
        a=np.asarray(jax.random.randint(k_ab, (n_laws,), 1, 97) * 2 + 1),
        b=np.asarray(jax.random.randint(jax.random.fold_in(k_ab, 1), (n_laws,), 0, vocab)),
        tok0=np.asarray(jax.random.randint(k_init, shape, 0, vocab)),
        flips=np.asarray(jax.random.bernoulli(k_noise, noise_p, shape + (seq_len,))),
        unif=np.asarray(jax.random.randint(k_unif, shape + (seq_len,), 0, vocab)))


@pytest.mark.parametrize("heterogeneous", [True, False], ids=["heterogeneous", "homogeneous"])
def test_token_stream_on_reference_draws(heterogeneous):
    args = (4, 48, 3, 512, heterogeneous, 0.2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(rsynthetic.make_token_stream(key, *args))
    got = synthetic.make_token_stream(draws=_reference_draws(key, *args), n_workers=4,
                                      seq_len=48, n_seqs_per_worker=3, vocab=512,
                                      device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (4, 3, 49)
    assert np.array_equal(got.numpy(), want)


def test_token_stream_follows_each_workers_law():
    W_, S_, V = 5, 256, 1000
    draws = synthetic.draw_token_stream(torch.Generator().manual_seed(8), W_, S_, 4, V,
                                        noise_p=0.1)
    toks = synthetic.make_token_stream(torch.Generator().manual_seed(8), W_, S_, 4, V,
                                       noise_p=0.1, device="cpu")
    assert torch.equal(toks, synthetic.make_token_stream(draws=draws, n_workers=W_,
                                                         seq_len=S_, n_seqs_per_worker=4,
                                                         vocab=V, device="cpu"))
    assert bool((draws.a % 2 == 1).all()) and len(set(draws.a.tolist())) > 1
    law = (draws.a[:, None, None] * toks[..., :-1] + draws.b[:, None, None]) % V
    follows = toks[..., 1:] == law
    kept = torch.cat([~draws.flips[..., :-1], torch.ones((W_, 4, 1), dtype=torch.bool)], -1)
    assert bool(follows[kept].all())  # every unflipped step and the label step
    assert abs(float(draws.flips.float().mean()) - 0.1) < 0.02


# ------------------------------------------------------- loss decreases
@pytest.mark.parametrize("n_workers", [1, 4])
def test_llm_train_loss_decreases(n_workers):
    """tests/test_system.py's run through the port: rfa + bucketing, worker
    momentum 0.9, lr 0.3, 30 steps of the affine-bigram stream; its gate."""
    cfg = configs.smoke_config("tinyllama-1.1b")
    byz = ByzConfig(aggregator="rfa", mixing="bucketing", s=2, worker_momentum=0.9)
    shape = InputShape("tiny", seq_len=64, global_batch=8, kind="train")
    step_fn, state = make_train_step(cfg, byz, lr=0.3, n_workers=n_workers, device="cpu")
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state = state["init_opt_state"](params)
    worker_m = state["init_worker_m"](params)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(30):
        seq = [torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=gen)]
        for _ in range(shape.seq_len):
            seq.append((seq[-1] * 3 + 7) % cfg.vocab_size)
        toks = torch.cat(seq, dim=1)
        mix = state["aggregator"].mixing_matrix(n_workers, gen, device="cpu")
        params, opt_state, worker_m, metrics = step_fn(
            params, opt_state, worker_m, mix, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses[::10]
