"""The port's kernel modules held against the reference's kernels.

On the CPU every wrapper takes its plain PyTorch version; the reference
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does.
CM and TM must agree BIT FOR BIT; mix and Gram at the reference's own
tolerances. The kernels themselves are tested on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import selection_network as rsel
from repro_torch.kernels import LAUNCHES, _build, reset_launches
from repro_torch.kernels import cwise_median, trimmed_mean
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selection_network as tsel

SHAPES = [(4, 128), (5, 3000), (10, 1000), (13, 2000), (25, 4097), (7, 64)]
WS = [2, 5, 10, 13, 25, 64]


def _xs(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


# ------------------------------------------------------- selection programs
@pytest.mark.parametrize("W", WS)
def test_selection_program_identical_tuples(W):
    for ranks in {rsel.median_ranks(W), rsel.trim_ranks(W, min(3, (W - 1) // 2)),
                  tuple(range(W))}:
        if ranks:
            assert tsel.selection_program(W, ranks) == rsel.selection_program(W, ranks)


def test_selection_program_sizes():
    sizes = [5, 10, 13, 25, 64]
    assert [len(tsel.selection_program(W, tsel.median_ranks(W))) for W in sizes] == \
        [8, 29, 39, 113, 445]
    assert [len(tsel.selection_program(W, tsel.trim_ranks(W, min(3, (W - 1) // 2))))
            for W in sizes] == [8, 29, 46, 138, 541]


def test_apply_program_propagates_nan():
    x = torch.tensor([[1.0, 2.0], [float("nan"), 0.0], [3.0, 1.0]])
    out = tsel.median_select(x)
    assert torch.isnan(out[0]) and out[1] == 1.0


@pytest.mark.parametrize("W,n_trim", [(5, None), (13, None), (10, None), (5, 1), (13, 5),
                                      (10, 0)])
def test_generated_source_carries_the_program(W, n_trim):
    if n_trim is None:
        (name, text), = cwise_median.sources(W)
        ranks = tsel.median_ranks(W)
    else:
        (name, text), = trimmed_mean.sources(W, n_trim)
        ranks = () if n_trim == 0 else tsel.trim_ranks(W, n_trim)
    assert not any(tag in text for tag in ("@W@", "@PROGRAM@", "@RESULT@"))
    assert f"#define SEL_W {W}" in text
    assert text.count("    CX(") == len(tsel.selection_program(W, ranks))
    assert _build.library_path(name, text).suffix == ".so"


# ------------------------------------------------- plain versions (CPU) vs ref
@pytest.mark.parametrize("shape", SHAPES)
def test_cm_aggregate_bitwise(shape):
    x = _xs(shape)
    expect = np.asarray(rops.cm_aggregate(jnp.asarray(x)))
    np.testing.assert_array_equal(tops.cm_aggregate(torch.tensor(x)).numpy(), expect)


@pytest.mark.parametrize("shape", SHAPES)
def test_tm_aggregate_bitwise(shape):
    W, _ = shape
    x = _xs(shape, seed=1)
    for n_trim in sorted({0, 1, (W - 1) // 2}):
        expect = np.asarray(rops.tm_aggregate(jnp.asarray(x), n_trim))
        np.testing.assert_array_equal(
            tops.tm_aggregate(torch.tensor(x), n_trim).numpy(), expect)


def test_tm_rejects_empty_band():
    with pytest.raises(ValueError):
        tops.tm_aggregate(torch.zeros(4, 128), 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_mix_apply_matches(shape):
    W, _ = shape
    x = _xs(shape)
    m = np.random.default_rng(1).uniform(size=(max(1, W // 2), W)).astype(np.float32)
    m /= m.sum(1, keepdims=True)
    expect = np.asarray(rops.mix_apply(jnp.asarray(m), jnp.asarray(x)))
    np.testing.assert_allclose(tops.mix_apply(torch.tensor(m), torch.tensor(x)).numpy(),
                               expect, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_matches(shape):
    x = _xs(shape)
    acc = _xs((shape[0], shape[0]), seed=2)
    acc = acc + acc.T
    np.testing.assert_allclose(tops.gram(torch.tensor(x)).numpy(),
                               np.asarray(rops.gram(jnp.asarray(x))), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tops.gram(torch.tensor(x), torch.tensor(acc)).numpy(),
        np.asarray(rops.gram(jnp.asarray(x), jnp.asarray(acc))), rtol=1e-5, atol=1e-3)


def test_cpu_wrappers_launch_nothing():
    reset_launches()
    x = torch.tensor(_xs((5, 300)))
    tops.cm_aggregate(x)
    tops.tm_aggregate(x, 1)
    tops.gram(x)
    tops.mix_apply(torch.full((1, 5), 0.2), x)
    assert all(v == 0 for v in LAUNCHES.values())


def test_cuda_wrappers_refuse_non_cuda_devices():
    x = torch.zeros((5, 300), device="meta")
    for call in (lambda: tops.cm_aggregate(x), lambda: tops.tm_aggregate(x, 1),
                 lambda: tops.gram(x),
                 lambda: tops.mix_apply(torch.zeros((1, 5), device="meta"), x)):
        with pytest.raises(ValueError):
            call()
