"""16-bit worker rows: the port's aggregation kernels and per-leaf engine on
bf16 / fp16 X, held against the reference, and ``kernels/cost.py`` held to
the bounds PERF.md states.

The reference's kernels take X in any float dtype and cast it to fp32 in
the kernel body; the port's convert at the load. The cast is exact, so
the fp32 tolerances apply: 1e-5 / 1e-4 mix and combine, 1e-5 / 1e-3 Gram,
1e-4 norms and CCLIP; CM and TM bit for bit. On the CPU every wrapper
takes its plain version; the reference runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does. The CUDA kernels' 16-bit
route is held bit for bit against its fp32 route in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
import torch_shard_ranks
from repro.core.aragg import RobustAggregator as RRobustAggregator
from repro.distributed.robust_sync import robust_gradient_sync as r_robust_gradient_sync
from repro.kernels import ops as rops
from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.kernels import CALLS, _build, cost, ops, reset_launches
from repro_torch.kernels.bucket_mix import bucket_mix
from repro_torch.kernels.cclip_combine import cclip_combine
from repro_torch.kernels.cclip_fused import cclip_fused_iter
from repro_torch.kernels.cwise_median import cwise_median
from repro_torch.kernels.pairwise_gram import pairwise_gram
from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean
from repro_torch.kernels.weiszfeld_norms import residual_norms

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
SHAPES = [(4, 128), (10, 1000), (25, 4097), (7, 64)]


def _rows(shape, dtype, seed=0):
    """Seeded rows rounded to ``dtype``: the port's tensor and the same values
    as the reference's array (the fp32 copy is exact)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    t = torch.tensor(x).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _vec(n, seed, low=False):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=n) if low else rng.standard_normal(n)).astype(np.float32)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_mix_and_gram_on_16bit_rows(dtype, shape):
    W, d = shape
    x, xj = _rows(shape, dtype)
    m = np.random.default_rng(1).uniform(size=(max(1, W // 2), W)).astype(np.float32)
    m /= m.sum(1, keepdims=True)
    got = bucket_mix(torch.tensor(m), x)
    assert got.dtype == torch.float32
    _close(got, rk.bucket_mix(jnp.asarray(m), xj), 1e-5, 1e-4)
    _close(pairwise_gram(x), rk.pairwise_gram(xj), 1e-5, 1e-3)
    acc = np.random.default_rng(2).standard_normal((W, W)).astype(np.float32)
    _close(pairwise_gram(x, torch.tensor(acc)), rk.pairwise_gram(xj, jnp.asarray(acc)),
           1e-5, 1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gram_leaf_chain_through_acc_on_16bit_rows(dtype):
    """The per-leaf engine's Gram on 16-bit leaves: a chain through ``acc``
    over leaves of unaligned widths equals one call on the leaves padded to
    2048 columns and packed, bit for bit, and the reference's chain
    (``full_blocks``: 2048-column blocks whatever d) within the Gram's
    tolerance."""
    leaves = [_rows((10, d), dtype, seed=d) for d in (10, 3000, 4100, 2048)]
    acc, racc = None, None
    for x, xj in leaves:
        acc = pairwise_gram(x, acc)
        racc = rk.pairwise_gram(xj, racc, full_blocks=True)
    pack = torch.cat([torch.nn.functional.pad(x, (0, -x.shape[1] % 2048)) for x, _ in leaves],
                     dim=1)
    assert torch.equal(acc, pairwise_gram(pack))
    _close(acc, racc, 1e-5, 1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cm_tm_on_16bit_rows_bitwise(dtype, shape):
    W, d = shape
    x, xj = _rows(shape, dtype, seed=3)
    np.testing.assert_array_equal(cwise_median(x).numpy(), np.asarray(rk.cwise_median(xj)))
    for b in sorted({0, 1, (W - 1) // 2}):
        np.testing.assert_array_equal(cwise_trimmed_mean(x, b).numpy(),
                                      np.asarray(rk.cwise_trimmed_mean(xj, b)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_norms_and_cclip_on_16bit_rows(dtype, shape):
    W, d = shape
    x, xj = _rows(shape, dtype, seed=4)
    c = np.asarray(jax.nn.softmax(jnp.asarray(_vec(W, 5))))
    v, lam = _vec(d, 6), _vec(W, 7, low=True)
    _close(residual_norms(x, torch.tensor(c)), rk.residual_norms(xj, jnp.asarray(c)), 1e-4, 1e-3)
    _close(residual_norms(x, center=torch.tensor(v)),
           rk.residual_norms(xj, center=jnp.asarray(v)), 1e-4, 1e-3)
    got_v, got_r = cclip_fused_iter(x, torch.tensor(v), torch.tensor(lam))
    want_v, want_r = rk.cclip_fused_iter(xj, jnp.asarray(v), jnp.asarray(lam))
    _close(got_v, want_v, 1e-4, 1e-4)
    _close(got_r, want_r, 1e-4, 1e-3)
    _close(cclip_combine(x, torch.tensor(v), torch.tensor(lam)),
           rk.cclip_combine(xj, jnp.asarray(v), jnp.asarray(lam)), 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_16bit_side_inputs_on_the_cpu(dtype):
    """A 16-bit mixing matrix, centre, lam or acc gives the result of its fp32
    value, as on the card (the wrappers cast them)."""
    x, _ = _rows((6, 300), dtype, seed=8)
    t16 = DTYPES[dtype][0]
    m = torch.rand((3, 6), generator=torch.Generator().manual_seed(0)).to(t16)
    v, lam = torch.randn(300).to(t16), torch.rand(6).to(t16)
    assert torch.equal(bucket_mix(m, x), bucket_mix(m.float(), x))
    assert torch.equal(residual_norms(x, center=v), residual_norms(x, center=v.float()))
    assert torch.equal(cclip_combine(x, v, lam), cclip_combine(x, v.float(), lam.float()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tau", [((10, 1000), 3.0), ((15, 900), 5.0)])
def test_ops_aggregates_on_16bit_rows(dtype, shape, tau):
    x, xj = _rows(shape, dtype, seed=9)
    _close(ops.rfa_aggregate(x), rops.rfa_aggregate(xj), 1e-4, 1e-4)
    _close(ops.cclip_aggregate(x, tau), rops.cclip_aggregate(xj, tau), 1e-4, 1e-4)
    _close(ops.cclip_aggregate_unfused(x, tau), rops.cclip_aggregate_unfused(xj, tau),
           1e-4, 1e-4)


# ------------------------------------------------- per-leaf engine, bf16 tree
W = 8
RULES = {"rfa": {}, "cm": {}, "tm": {"n_trim": 2}}


def _tree(dtype=torch.bfloat16):
    """Leaves that are not 2048-aligned, one past a 2048 boundary."""
    shapes = {"w": (W, 16, 48), "b": (W, 33), "v": (W, 2049), "u": (W, 3, 5)}
    rng = np.random.default_rng(0)
    return {k: torch.tensor(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for k, s in shapes.items()}


def _mix(agg):
    rra = RRobustAggregator.from_spec(agg, mixing="bucketing", s=2, **RULES[agg])
    return rra, np.asarray(rra.mixing_matrix(jax.random.PRNGKey(11), W))


@pytest.mark.parametrize("agg", list(RULES))
def test_per_leaf_bf16_tree_hands_leaves_over_in_their_dtype(agg, monkeypatch):
    """With ``use_kernels=True`` the per-leaf engine passes each bf16 leaf to
    the kernels as it is (no fp32 copy), and its aggregate equals the packed
    engine's (which packs to fp32) bit for bit."""
    seen = []
    for name in ("pairwise_gram", "bucket_mix"):
        mod = __import__(f"repro_torch.kernels.{name}", fromlist=[name])
        real = getattr(mod, name)

        def spy(*args, real=real, **kw):
            xs = args[-1] if real.__name__ == "bucket_mix" else args[0]
            seen.append(xs.dtype)
            return real(*args, **kw)
        monkeypatch.setattr(ops, "gram" if name == "pairwise_gram" else "mix_apply", spy)
    tree = _tree()
    ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **RULES[agg])
    mix = torch.tensor(_mix(agg)[1])
    packed, _ = robust_gradient_sync(tree, ra, mix=mix)
    assert set(seen) == {torch.float32}, seen  # the packed buffer
    seen.clear()
    per_leaf, _ = robust_gradient_sync(tree, ra, mix=mix, engine="per_leaf", use_kernels=True)
    assert len(seen) == (8 if agg == "rfa" else 4) and set(seen) == {torch.bfloat16}, seen
    for k in tree:
        assert per_leaf[k].dtype == torch.bfloat16
        assert torch.equal(per_leaf[k], packed[k]), k


@pytest.mark.parametrize("agg", list(RULES))
def test_per_leaf_bf16_tree_matches_the_reference(agg):
    """The reference's per-leaf engine with its kernels on the same bf16 tree
    and mixing matrix, in fp32 before the cast back to bf16: the
    aggregation weights (rfa) at 1e-4, and every output within 1e-4 or one
    bf16 rounding step (an fp32 value near a bf16 rounding boundary may
    round the other way when the sums ran in another order); CM and TM
    bit for bit."""
    rra, mix = _mix(agg)
    tree = _tree()
    ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **RULES[agg])
    got, info = robust_gradient_sync(tree, ra, mix=torch.tensor(mix), engine="per_leaf",
                                     use_kernels=True)
    rtree = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in tree.items()}
    want, rinfo = r_robust_gradient_sync(rtree, rra, key=jax.random.PRNGKey(11),
                                         engine="per_leaf", use_kernels=True)
    if agg == "rfa":
        _close(info["agg_weights"], rinfo["agg_weights"], 1e-4, 1e-4)
    for k in tree:
        g = got[k].float().numpy()
        w = np.asarray(want[k].astype(jnp.float32))
        assert want[k].dtype == jnp.bfloat16 and got[k].dtype == torch.bfloat16
        if agg in ("cm", "tm"):
            np.testing.assert_array_equal(g, w)
        else:
            step = np.abs(w) * 2.0 ** -7 + 1e-30  # one bf16 ulp is at most |w| 2^-7
            off = np.abs(g - w)
            assert np.all((off <= 1e-4 + 1e-4 * np.abs(w)) | (off <= step)), k
            assert np.mean(off > 1e-4 + 1e-4 * np.abs(w)) < 0.01, k


# ------------------------------------------------------ the cost table
def test_cost_gives_the_perf_table_bounds():
    """``kernels/cost.py`` at the path shapes gives PERF.md's fp32 bounds:
    the mix 5x10 at d = 106,496, the Gram 10x106,496, and the Gram at
    TinyLlama-1.1B's X[4, n_pad]; 16-bit X halves X's bytes."""
    d = 106_496
    ms, by = cost.bucket_mix(5, 10, d).bound()
    assert (round(ms, 6), by) == (0.001907, "bytes")
    ms, by = cost.pairwise_gram(10, d).bound()
    assert (round(ms, 6), by) == (0.001272, "bytes")
    from repro_torch.configs import get_config
    from repro_torch.distributed.packing import packer_for
    from repro_torch.models import transformer as tfm

    from repro_torch.utils.tree import TensorSpec, tree_map

    specs = tfm.params_shape(get_config("tinyllama-1.1b"))
    n_pad = packer_for(tree_map(lambda s: TensorSpec((4,) + tuple(s.shape), s.dtype),
                                specs)).n_pad
    assert round(cost.pairwise_gram(4, n_pad).bound()[0], 3) == 5.254
    assert cost.pairwise_gram(4, n_pad, x_bytes=2).bytes == 4 * n_pad * 2 + 16 * 4
    assert cost.selection(5, d).bytes == (5 * 4 + 4) * d
    assert cost.selection(5, d, None, 2).bytes == (5 * 2 + 4) * d


def test_fake_tensors_launch_nothing_and_record_their_cost():
    """A kernel wrapper handed a fake tensor returns an empty output of the
    right shape and dtype, counts a call and no launch, checks and builds
    nothing, and records the call's bytes and operations."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import flash_attention

    cost.reset()
    reset_launches()
    with FakeTensorMode():
        x = torch.empty((10, 4096), dtype=torch.bfloat16, device="cuda")
        v, lam = torch.empty(4096, device="cuda"), torch.empty(10, device="cuda")
        outs = {
            "bucket_mix": bucket_mix(torch.empty((5, 10), device="cuda"), x),
            "pairwise_gram": pairwise_gram(x),
            "cwise_median": cwise_median(x),
            "cwise_trimmed_mean": cwise_trimmed_mean(x, 1),
            "residual_norms": residual_norms(x, center=v),
            "cclip_fused_iter": cclip_fused_iter(x, v, lam)[1],
            "cclip_combine": cclip_combine(x, v, lam),
        }
        q = torch.empty((1, 128, 4, 64), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="cuda")
        att = flash_attention(q, kv, kv)
    shapes = {"bucket_mix": (5, 4096), "pairwise_gram": (10, 10), "cwise_median": (4096,),
              "cwise_trimmed_mean": (4096,), "residual_norms": (10,),
              "cclip_fused_iter": (10,), "cclip_combine": (4096,)}
    for name, out in outs.items():
        assert _build.is_fake(out) and tuple(out.shape) == shapes[name], name
        assert out.dtype == torch.float32 and out.device.type == "cuda", name
    assert att.dtype == torch.bfloat16 and tuple(att.shape) == (1, 128, 4, 64)
    assert all(n == 0 for n in LAUNCHES.values())
    assert all(CALLS[k] == 1 for k in LAUNCHES)
    assert {k: r["calls"] for k, r in cost.COSTS.items()} == dict.fromkeys(LAUNCHES, 1)
    assert cost.COSTS["pairwise_gram"]["bytes"] == cost.pairwise_gram(10, 4096, 2).bytes
    assert cost.COSTS["bucket_mix"]["ops"] == 2 * 5 * 10 * 4096
    cost.reset()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_per_leaf_16bit_tree_over_a_group(dtype):
    """Over 3 gloo ranks the per-leaf engine slices each 16-bit leaf's columns
    in its own dtype (zero padding included: 3 does not divide every leaf)
    and hands them to the sharded kernels as they are; the column-local
    rules (CM, TM) equal the one-device per-leaf engine bit for bit."""
    from repro_torch.launch.mesh import spawn_ranks

    t16 = getattr(torch, dtype)
    tree = _tree(t16)
    mixes = {agg: _mix(agg)[1] for agg in ("cm", "tm")}
    payload = {"tree": {k: v.float().numpy() for k, v in tree.items()}, "dtype": dtype,
               "mixes": mixes, "rules": {agg: RULES[agg] for agg in mixes}}
    results = spawn_ranks(torch_shard_ranks.per_leaf_16bit, 3, backend="gloo",
                          devices=["cpu"] * 3, args=(payload,), timeout_s=300)
    for agg, mix in mixes.items():
        ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **RULES[agg])
        want, _ = robust_gradient_sync(tree, ra, mix=torch.tensor(mix), engine="per_leaf",
                                       use_kernels=True)
        for r in results:
            for k in tree:
                np.testing.assert_array_equal(r["out"][agg][k], want[k].float().numpy())
    assert all(set(r["seen"]) == {str(t16)} and len(r["seen"]) == 8 for r in results)
