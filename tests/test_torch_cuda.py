"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs where the port runs:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where CUDA is unavailable.
"""

import pytest
import torch

from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels import bucket_mix, cwise_median, pairwise_gram, trimmed_mean


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,d", [(5, 106_496), (10, 106_496), (13, 100_003), (64, 4097)])
def test_kernels_match_plain_on_card(cuda, W, d):
    x = torch.randn((W, d), device=cuda, generator=torch.Generator(cuda).manual_seed(0)) * 3
    m = torch.rand((max(1, W // 2), W), device=cuda)
    m = m / m.sum(1, keepdim=True)
    torch.testing.assert_close(bucket_mix.bucket_mix(m, x), ref.bucket_mix(m, x),
                               rtol=1e-5, atol=1e-4)
    # fp32 rounding of a dot product scales with sum_k |x_ik x_jk|, which
    # cancelling off-diagonal entries do not show: rtol 1e-5 against |X||X|^T
    scale = x.abs() @ x.abs().T
    err = (pairwise_gram.pairwise_gram(x) - ref.pairwise_gram(x)).abs()
    assert bool((err <= 1e-3 + 1e-5 * scale).all()), float(err.max())
    assert torch.equal(cwise_median.cwise_median(x), ref.cwise_median(x))
    for b in sorted({0, 1, (W - 1) // 2}):
        assert torch.equal(trimmed_mean.cwise_trimmed_mean(x, b),
                           ref.cwise_trimmed_mean(x, b))


@pytest.mark.cuda
def test_gram_chain_and_repeat_bitwise_on_card(cuda):
    x = torch.randn((25, 5 * pairwise_gram.TILE_D), device=cuda)
    whole = pairwise_gram.pairwise_gram(x)
    assert torch.equal(whole, pairwise_gram.pairwise_gram(x))
    assert torch.equal(whole, whole.T)
    acc = None
    for lo, hi in [(0, 2), (2, 3), (3, 5)]:
        seg = x[:, lo * pairwise_gram.TILE_D:hi * pairwise_gram.TILE_D].contiguous()
        acc = pairwise_gram.pairwise_gram(seg, acc)
    assert torch.equal(acc, whole)


@pytest.mark.cuda
def test_each_launch_counts_once(cuda):
    x = torch.randn((5, 4096), device=cuda)
    reset_launches()
    bucket_mix.bucket_mix(torch.full((1, 5), 0.2, device=cuda), x)
    pairwise_gram.pairwise_gram(x)
    cwise_median.cwise_median(x)
    trimmed_mean.cwise_trimmed_mean(x, 1)
    assert LAUNCHES == {"bucket_mix": 1, "pairwise_gram": 1, "cwise_median": 1,
                        "cwise_trimmed_mean": 1}


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn((5, 4096), device=cuda)
    with pytest.raises(TypeError):
        cwise_median.cwise_median(x.double())
    with pytest.raises(ValueError):
        pairwise_gram.pairwise_gram(x.T)
    with pytest.raises(ValueError):
        bucket_mix.bucket_mix(torch.ones((1, 65), device=cuda), torch.ones((65, 8), device=cuda))
