"""The port's residual-norm and centered-clipping kernels, and the ``ops``
compositions built on them, held against the reference.

On the CPU every wrapper takes its plain PyTorch version; the reference
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does,
and its tolerances apply. The kernels themselves are tested on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cclip_combine as r_cclip_combine
from repro.kernels import cclip_fused_iter as r_cclip_fused_iter
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import residual_norms as r_residual_norms
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cclip_combine import cclip_combine
from repro_torch.kernels.cclip_fused import cclip_fused_iter
from repro_torch.kernels.weiszfeld_norms import residual_norms

EDGES = [(1, 300), (6, 1), (1, 1)]


def _xs(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


def _vec(n, seed, low=None):
    rng = np.random.default_rng(seed)
    out = rng.uniform(size=n) if low is not None else rng.standard_normal(n)
    return out.astype(np.float32)


def _softmax(z):
    e = np.exp(z - z.max())
    return (e / e.sum()).astype(np.float32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ----------------------------------------------------------- residual_norms
@pytest.mark.parametrize("shape", [(10, 1000), (53, 257)] + EDGES)
def test_residual_norms_coefficient_form(shape):
    W, d = shape
    x, c = _xs(shape), _softmax(_vec(W, 2))
    expect = np.asarray(r_residual_norms(*_j(x, c)))
    np.testing.assert_allclose(residual_norms(*_t(x, c)).numpy(), expect,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tops.norms(*_t(x, c)).numpy(),
                               np.asarray(rref.residual_norms(*_j(x, c))), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(10, 1000), (53, 257)] + EDGES)
def test_residual_norms_explicit_center(shape):
    W, d = shape
    x, v = _xs(shape), _vec(d, 5)
    xj, vj = _j(x, v)
    expect = np.asarray(r_residual_norms(xj, center=vj))
    np.testing.assert_allclose(residual_norms(torch.tensor(x), center=torch.tensor(v)).numpy(),
                               expect, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(expect, np.asarray(jnp.sum((xj - vj[None]) ** 2, axis=1)),
                               rtol=1e-4, atol=1e-3)


def test_residual_norms_takes_exactly_one_centre():
    x = torch.tensor(_xs((4, 50)))
    c, v = torch.full((4,), 0.25), torch.zeros(50)
    for call in (lambda f: f(x), lambda f: f(x, c, center=v)):
        for fn in (residual_norms, tops.norms, ref.residual_norms):
            with pytest.raises(ValueError):
                call(fn)
    with pytest.raises(ValueError):
        residual_norms(x, torch.full((5,), 0.2))
    with pytest.raises(ValueError):
        residual_norms(x, center=torch.zeros(49))


# ----------------------------------------------------------- cclip kernels
@pytest.mark.parametrize("shape", [(10, 1000), (25, 4097)] + EDGES)
def test_cclip_fused_iter_matches(shape):
    W, d = shape
    x, v, lam = _xs(shape), _vec(d, 6), _vec(W, 7, low=0)
    v_ref, r2_ref = (np.asarray(a) for a in r_cclip_fused_iter(*_j(x, v, lam)))
    for fn in (cclip_fused_iter, tops.cclip_iter):
        v_new, r2 = fn(*_t(x, v, lam))
        np.testing.assert_allclose(v_new.numpy(), v_ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(r2.numpy(), r2_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(4, 128), (10, 1000), (25, 4097), (53, 257), (64, 8192)]
                         + EDGES)
def test_cclip_combine_matches(shape):
    W, d = shape
    x, v, lam = _xs(shape), _vec(d, 3), _vec(W, 4, low=0)
    expect = np.asarray(r_cclip_combine(*_j(x, v, lam)))
    np.testing.assert_allclose(cclip_combine(*_t(x, v, lam)).numpy(), expect,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ref.cclip_combine(*_t(x, v, lam)).numpy(),
                               np.asarray(rref.cclip_combine(*_j(x, v, lam))),
                               rtol=1e-5, atol=1e-4)


def test_update_kernels_check_shapes():
    x = torch.tensor(_xs((4, 50)))
    for fn in (cclip_fused_iter, cclip_combine):
        with pytest.raises(ValueError):
            fn(x, torch.zeros(49), torch.ones(4))
        with pytest.raises(ValueError):
            fn(x, torch.zeros(50), torch.ones(5))


# ---------------------------------------------------------- ops compositions
@pytest.mark.parametrize("shape", [(21, 1500), (10, 1000)] + EDGES)
def test_ops_rfa_aggregate_matches(shape):
    x = _xs(shape)
    want = np.asarray(rops.rfa_aggregate(jnp.asarray(x)))
    np.testing.assert_allclose(tops.rfa_aggregate(torch.tensor(x)).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.rfa_aggregate(torch.tensor(x)).numpy(),
                               np.asarray(rref.rfa_aggregate(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,tau", [((15, 900), 5.0), ((10, 1000), 3.0), ((25, 4097), 3.0)]
                         + [(s, 3.0) for s in EDGES])
def test_ops_cclip_aggregate_matches(shape, tau):
    x = _xs(shape)
    want = np.asarray(rops.cclip_aggregate(jnp.asarray(x), tau))
    for fn in (tops.cclip_aggregate, tops.cclip_aggregate_unfused):
        np.testing.assert_allclose(fn(torch.tensor(x), tau).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tops.cclip_aggregate_unfused(torch.tensor(x), tau).numpy(),
        np.asarray(rops.cclip_aggregate_unfused(jnp.asarray(x), tau)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.cclip_aggregate(torch.tensor(x), tau).numpy(),
                               np.asarray(rref.cclip_aggregate(jnp.asarray(x), tau)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_iters", [1, 5])
def test_ops_iteration_counts_follow_the_reference(n_iters):
    x = _xs((13, 700), seed=4)
    np.testing.assert_allclose(
        tops.rfa_aggregate(torch.tensor(x), n_iters=n_iters).numpy(),
        np.asarray(rops.rfa_aggregate(jnp.asarray(x), n_iters=n_iters)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tops.cclip_aggregate(torch.tensor(x), 3.0, n_iters=n_iters).numpy(),
        np.asarray(rops.cclip_aggregate(jnp.asarray(x), 3.0, n_iters=n_iters)),
        rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ CPU dispatch
def test_new_cpu_wrappers_launch_nothing():
    reset_launches()
    x = torch.tensor(_xs((5, 300)))
    tops.rfa_aggregate(x)
    tops.cclip_aggregate(x, 3.0)
    tops.cclip_aggregate_unfused(x, 3.0)
    assert all(v == 0 for v in LAUNCHES.values())
    assert {"residual_norms", "cclip_fused_iter", "cclip_combine"} <= set(LAUNCHES)


def test_new_wrappers_refuse_non_cuda_devices():
    x = torch.zeros((5, 300), device="meta")
    v, lam = torch.zeros(300, device="meta"), torch.ones(5, device="meta")
    for call in (lambda: residual_norms(x, lam), lambda: residual_norms(x, center=v),
                 lambda: cclip_fused_iter(x, v, lam), lambda: cclip_combine(x, v, lam)):
        with pytest.raises(ValueError):
            call()
