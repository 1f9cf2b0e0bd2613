"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs where the port runs:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where CUDA is unavailable.
"""

import pytest
import torch

from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels import bucket_mix, cwise_median, pairwise_gram, trimmed_mean
from repro_torch.kernels.cclip_combine import cclip_combine
from repro_torch.kernels.cclip_fused import cclip_fused_iter
from repro_torch.kernels.weiszfeld_norms import residual_norms


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
    v, lam = torch.randn(4096, device=cuda), torch.rand(5, device=cuda)
    reset_launches()
    bucket_mix.bucket_mix(torch.full((1, 5), 0.2, device=cuda), x)
    pairwise_gram.pairwise_gram(x)
    cwise_median.cwise_median(x)
    trimmed_mean.cwise_trimmed_mean(x, 1)
    residual_norms(x, center=v)
    cclip_fused_iter(x, v, lam)
    cclip_combine(x, v, lam)
    assert LAUNCHES == {"bucket_mix": 1, "pairwise_gram": 1, "cwise_median": 1,
                        "cwise_trimmed_mean": 1, "residual_norms": 1, "cclip_fused_iter": 1,
                        "cclip_combine": 1}


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn((5, 4096), device=cuda)
    with pytest.raises(TypeError):
        cwise_median.cwise_median(x.double())
    with pytest.raises(ValueError):
        pairwise_gram.pairwise_gram(x.T)
    with pytest.raises(ValueError):
        bucket_mix.bucket_mix(torch.ones((1, 65), device=cuda), torch.ones((65, 8), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("W,d", [(1, 1), (5, 26_624), (10, 106_496), (26, 100_003),
                                 (64, 4097)])
def test_norm_and_clip_kernels_match_plain_on_card(cuda, W, d):
    gen = torch.Generator(cuda).manual_seed(W)
    x = torch.randn((W, d), device=cuda, generator=gen) * 3
    c = torch.softmax(torch.randn(W, device=cuda, generator=gen), 0)
    v = torch.randn(d, device=cuda, generator=gen)
    lam = torch.rand(W, device=cuda, generator=gen)
    # sums of W d terms in another order than the plain version's: the
    # reference's own tolerances (tests/test_kernels.py)
    torch.testing.assert_close(residual_norms(x, c), ref.residual_norms(x, c),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(residual_norms(x, center=v), ref.residual_norms(x, center=v),
                               rtol=1e-4, atol=1e-3)
    v_new, r2 = cclip_fused_iter(x, v, lam)
    v_ref, r2_ref = ref.cclip_fused_iter(x, v, lam)
    torch.testing.assert_close(v_new, v_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(r2, r2_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(cclip_combine(x, v, lam), ref.cclip_combine(x, v, lam),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_norms_repeat_bitwise_on_card(cuda):
    x = torch.randn((25, 300_001), device=cuda)
    c = torch.full((25,), 0.04, device=cuda)
    v, lam = torch.randn(300_001, device=cuda), torch.rand(25, device=cuda)
    assert torch.equal(residual_norms(x, c), residual_norms(x, c))
    assert torch.equal(residual_norms(x, center=v), residual_norms(x, center=v))
    a, b = cclip_fused_iter(x, v, lam), cclip_fused_iter(x, v, lam)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_norm_and_clip_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn((5, 4096), device=cuda)
    v, lam = torch.randn(4096, device=cuda), torch.rand(5, device=cuda)
    wide = torch.randn((65, 64), device=cuda)
    for call in (lambda: residual_norms(x.double(), lam.double()),
                 lambda: residual_norms(x, center=v.half()),
                 lambda: cclip_fused_iter(x, v.double(), lam),
                 lambda: cclip_combine(x.bfloat16(), v, lam)):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: residual_norms(wide, torch.rand(65, device=cuda)),
                 lambda: cclip_fused_iter(wide, torch.zeros(64, device=cuda),
                                          torch.rand(65, device=cuda)),
                 lambda: cclip_combine(wide, torch.zeros(64, device=cuda),
                                       torch.rand(65, device=cuda)),
                 lambda: residual_norms(x, center=v.cpu())):
        with pytest.raises(ValueError):
            call()
