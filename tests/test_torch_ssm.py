"""The port's Mamba-2 (SSD) block held against the JAX reference on the CPU.

``tests/test_ssm.py``'s cases run through ``repro_torch.models.ssm``: the
chunked scan against the naive recurrence (a torch copy of that test's
oracle) for each chunk size and over a grid of shapes, chunk invariance,
``_segsum_exp``'s structure, the conv's causality and the layer's decode
against its train path. Then each function against the reference on the
same numpy inputs from a seed, with the reference's parameters carried
across by ``convert.params_from_jax``.

Tolerances: the naive-recurrence, chunk-invariance and decode-vs-train
cases keep ``tests/test_ssm.py``'s bars (1e-4; 5e-4 over the shape grid;
3e-3). Against the reference in fp32: rtol / atol 1e-5 (the two packages
sum the same products in other orders), ``softplus`` within 1e-6 of
itself (``logaddexp``'s last bits differ by up to 3 ulp; XLA flushes
subnormals to zero), the conv bit for bit (the same fp32 adds in the same
order), the gradients of ``ssm_layer`` at 1e-4 against ``jax.grad``. In
bf16, ``ssm_layer`` and its gradients at 2e-2 of the largest entry, the
bf16 bar of ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    x = x.detach()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def naive_ssd(x, dt, A, B_, C_):
    """Direct O(S) recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;
    y_t = h_t C_t. Shapes as ``ssd_scan`` (tests/test_ssm.py's oracle)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    h = torch.zeros((Bsz, H, P, N))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], B_[:, t, 0])
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t, 0]))
    return torch.stack(ys, dim=1), h


def _scan_inputs(seed, Bsz, S, H, P, N, a_scale=0.5):
    rng = np.random.default_rng(seed)
    x = _rand((Bsz, S, H, P), rng)
    dt = np.asarray(jax.nn.softplus(_rand((Bsz, S, H), rng)))
    A = -np.exp(_rand((H,), rng, a_scale))
    B_ = _rand((Bsz, S, 1, N), rng)
    C_ = _rand((Bsz, S, 1, N), rng)
    return x, dt, A, B_, C_


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


# ---------------------------------------------- tests/test_ssm.py's cases
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_scan_matches_naive_recurrence(chunk):
    args = _t(*_scan_inputs(0, 2, 16, 3, 4, 8))
    y_chunk, h_chunk = ssm.ssd_scan(*args, chunk)
    y_naive, h_naive = naive_ssd(*args)
    np.testing.assert_allclose(y_chunk.numpy(), y_naive.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_chunk.numpy(), h_naive.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_scan_chunk_invariance():
    """Different chunk sizes give the same result."""
    args = _t(*_scan_inputs(1, 1, 32, 2, 4, 4, a_scale=0.3))
    y4, _ = ssm.ssd_scan(*args, 4)
    y32, _ = ssm.ssd_scan(*args, 32)
    np.testing.assert_allclose(y4.numpy(), y32.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,H,P,N,seed", [(8, 1, 2, 2, 2), (16, 4, 4, 8, 3), (24, 3, 2, 8, 4),
                                          (24, 2, 4, 2, 5), (16, 1, 4, 2, 6)])
def test_ssd_scan_shapes_match_naive(S, H, P, N, seed):
    """The property test of tests/test_ssm.py over a fixed grid of its
    shapes (chunk 8 where it divides S, else S), at its bar 5e-4."""
    args = _t(*_scan_inputs(seed, 1, S, H, P, N, a_scale=0.3))
    chunk = 8 if S % 8 == 0 else S
    y_c, h_c = ssm.ssd_scan(*args, chunk)
    y_n, h_n = naive_ssd(*args)
    np.testing.assert_allclose(y_c.numpy(), y_n.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(h_c.numpy(), h_n.numpy(), rtol=5e-4, atol=5e-4)


def test_ssd_scan_refuses_a_ragged_sequence():
    args = _t(*_scan_inputs(0, 1, 12, 2, 2, 2))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_scan(*args, 8)


def test_segsum_exp_structure():
    L = ssm._segsum_exp(torch.tensor([[0.1, -0.2, 0.3]]))[0]
    assert L.shape == (3, 3)
    # strictly upper triangle is zero; diagonal is exp(0) = 1
    np.testing.assert_allclose(torch.diagonal(L).numpy(), 1.0, rtol=1e-6)
    assert float(L[0, 1]) == 0.0
    # L[2, 0] = exp(da_1 + da_2) (the decay from step 0 to 2 excludes da_0)
    np.testing.assert_allclose(float(L[2, 0]), np.exp(np.float32(-0.2 + 0.3)), rtol=1e-6)


def test_causal_conv_is_causal():
    rng = np.random.default_rng(7)
    x, w = torch.tensor(_rand((1, 10, 6), rng)), torch.tensor(_rand((6, 4), rng))
    b = torch.zeros(6)
    y1 = ssm._causal_conv(x, w, b)
    x2 = x.clone()
    x2[:, -1] = 0.0
    y2 = ssm._causal_conv(x2, w, b)
    np.testing.assert_allclose(y1[:, :-1].numpy(), y2[:, :-1].numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ against the reference
def _layer(dtype="float32", seed=0):
    """The smoke Mamba2 block of both packages, the reference's parameters
    carried across; ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and the norm
    scale drawn away from their constant inits so that each term counts."""
    cfg = dataclasses.replace(configs.smoke_config("mamba2-130m"), dtype=dtype)
    rcfg = dataclasses.replace(rconfigs.smoke_config("mamba2-130m"), dtype=dtype)
    rng = np.random.default_rng(seed + 100)
    rp = dict(rssm.init_ssm(jax.random.PRNGKey(seed), rcfg))
    for k, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 1.0), ("conv_b", 0.1),
                     ("norm_scale", 0.2)):
        rp[k] = jnp.asarray(_rand(rp[k].shape, rng, scale)).astype(rp[k].dtype)
    rp = jax.tree_util.tree_map(np.asarray, rp)
    return cfg, rcfg, rp, params_from_jax(rp, device="cpu")


def test_init_ssm_matches_the_reference_tree():
    """Names, shapes and dtypes of the reference's leaves: ``A_log``, ``D``
    and ``dt_bias`` fp32 in a bf16 model; the cache's leaves likewise."""
    cfg = dataclasses.replace(configs.smoke_config("mamba2-130m"), dtype="bfloat16")
    rcfg = dataclasses.replace(rconfigs.smoke_config("mamba2-130m"), dtype="bfloat16")
    mine = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, "cpu")
    theirs = jax.eval_shape(lambda: rssm.init_ssm(jax.random.PRNGKey(0), rcfg))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in mine.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in theirs.items()}
    assert {k for k, v in mine.items() if v.dtype == torch.float32} == {"A_log", "D", "dt_bias"}
    cache = ssm.init_ssm_cache(3, cfg, torch.bfloat16, "cpu")
    rcache = rssm.init_ssm_cache(3, rcfg, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in rcache.items()}


def test_softplus_and_segsum_match():
    rng = np.random.default_rng(8)
    v = np.concatenate([_rand(20000, rng, 30.0), _rand(20000, rng),
                        np.asarray([0, 19.9, 20, 20.5, 30, 88, 100, -20.1, -100],
                                   np.float32)])
    np.testing.assert_allclose(ssm.softplus(torch.tensor(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-37)
    da = _rand((2, 3, 4, 16), rng, 0.5)
    np.testing.assert_allclose(ssm._segsum_exp(torch.tensor(da)).numpy(),
                               np.asarray(rssm._segsum_exp(jnp.asarray(da))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_bit_for_bit(dtype):
    rng = np.random.default_rng(9)
    x, w, b = _rand((2, 24, 40), rng), _rand((40, 4), rng), _rand((40,), rng)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    want = np.asarray(rssm._causal_conv(jx, jw, jb))
    got = ssm._causal_conv(*(params_from_jax(np.asarray(a), device="cpu") for a in (jx, jw, jb)))
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_array_equal(_np(got), want.astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_scan_matches_reference(chunk):
    x, dt, A, B_, C_ = _scan_inputs(10, 2, 32, 3, 4, 8)
    y, h = ssm.ssd_scan(*_t(x, dt, A, B_, C_), chunk)
    ry, rh = rssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B_, C_)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-5)


def _grads(cfg, rcfg, rp, tp, x):
    """The layer's output and the gradients of ``sum(out^2)`` in both
    packages (sorted leaf order)."""
    def rloss(p):
        return jnp.sum(rssm.ssm_layer(p, jnp.asarray(x).astype(rcfg.dtype), rcfg)
                       .astype(jnp.float32) ** 2)

    rout = rssm.ssm_layer(rp, jnp.asarray(x).astype(rcfg.dtype), rcfg)
    rg = jax.grad(rloss)(jax.tree_util.tree_map(jnp.asarray, rp))
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out = ssm.ssm_layer(live, torch.tensor(x).to(getattr(torch, cfg.dtype)), cfg)
    (out.float() ** 2).sum().backward()
    return out, {k: v.grad for k, v in live.items()}, rout, rg


def test_ssm_layer_and_gradients_match_fp32():
    cfg, rcfg, rp, tp = _layer()
    x = _rand((2, 32, cfg.d_model), np.random.default_rng(11), 0.5)
    out, grads, rout, rg = _grads(cfg, rcfg, rp, tp, x)
    np.testing.assert_allclose(_np(out), np.asarray(rout), rtol=1e-5, atol=1e-5)
    assert sorted(grads) == sorted(rg)
    for k in grads:
        assert grads[k].dtype == tp[k].dtype
        np.testing.assert_allclose(_np(grads[k]), np.asarray(rg[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_ssm_layer_and_gradients_match_bf16():
    """bf16 parameters and input: the output and every gradient within 2e-2
    of the largest entry; the fp32 leaves' gradients stay fp32."""
    cfg, rcfg, rp, tp = _layer("bfloat16", seed=1)
    x = _rand((2, 32, cfg.d_model), np.random.default_rng(12), 0.5)
    out, grads, rout, rg = _grads(cfg, rcfg, rp, tp, x)
    assert out.dtype == torch.bfloat16

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(got) / scale, want / scale, rtol=2e-2, atol=2e-2,
                                   err_msg=what)

    close(out, rout, "out")
    for k in grads:
        assert grads[k].dtype == tp[k].dtype
        close(grads[k], rg[k], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ssm_matches_reference_step_by_step(dtype):
    """12 recurrent steps from a zero state: each output and the new state
    (conv ring and SSM state) against the reference's, at 1e-5 in fp32,
    2e-2 of the largest entry in bf16; the state passed in is left as it
    was."""
    cfg, rcfg, rp, tp = _layer(dtype, seed=2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    x = _rand((2, 12, cfg.d_model), np.random.default_rng(13), 0.5)
    cache = ssm.init_ssm_cache(2, cfg, getattr(torch, dtype), "cpu")
    rcache = rssm.init_ssm_cache(2, rcfg, jnp.dtype(dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    for t in range(12):
        before = {k: v.clone() for k, v in cache.items()}
        out, new = ssm.decode_ssm(tp, xt[:, t:t + 1], cache, cfg)
        assert all(torch.equal(before[k], cache[k]) for k in cache)
        rout, rcache = rssm.decode_ssm(rp, jnp.asarray(x[:, t:t + 1]).astype(dtype), rcache, rcfg)
        for got, want in [(out, rout)] + [(new[k], rcache[k]) for k in ("conv", "ssm")]:
            want = np.asarray(want, np.float32)
            assert got.shape == want.shape
            scale = 1.0 if dtype == "float32" else max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(_np(got) / scale, want / scale, rtol=tol, atol=tol)
        cache = new
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == getattr(torch, dtype)


def test_ssm_layer_decode_matches_train():
    """tests/test_ssm.py's layer-level case: step-by-step decode equals the
    chunked train path (its bar 3e-3), on the port's own parameters."""
    cfg = configs.smoke_config("mamba2-130m")
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, "cpu")
    B, S = 1, 12
    h = torch.tensor(_rand((B, S, cfg.d_model), np.random.default_rng(14), 0.3))
    full = ssm.ssm_layer(p, h, cfg)
    cache = ssm.init_ssm_cache(B, cfg, torch.float32, "cpu")
    for t in range(S):
        out, cache = ssm.decode_ssm(p, h[:, t:t + 1], cache, cfg)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(), rtol=3e-3, atol=3e-3)


def test_masked_segsum_overflow_gives_nan_gradients_as_the_reference():
    """A chunk whose summed decay passes fp32's ``exp`` range: the masked
    entries overflow to inf and the gradient through the ``where`` is NaN,
    in the port as in the reference (the form is kept, not repaired)."""
    da = np.full((1, 8), -14.0, np.float32)  # masked entries up to exp(7 x 14) = inf

    def rsum(d):
        return jnp.sum(rssm._segsum_exp(d))

    rg = np.asarray(jax.grad(rsum)(jnp.asarray(da)))
    d = torch.tensor(da, requires_grad=True)
    ssm._segsum_exp(d).sum().backward()
    assert np.isnan(rg).any() and np.array_equal(np.isnan(d.grad.numpy()), np.isnan(rg))
