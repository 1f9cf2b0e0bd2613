"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs where the port runs:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where CUDA is unavailable.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, _build, ref, reset_launches
from repro_torch.kernels import (bucket_mix, cclip_fused, cwise_median, pairwise_gram,
                                 trimmed_mean)
from repro_torch.kernels.cclip_combine import cclip_combine
from repro_torch.kernels.cclip_fused import cclip_fused_iter
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.weiszfeld_norms import residual_norms
from repro_torch.models import moe
from repro_torch.utils.tree import tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attention_variants():
    return {k: VARIANT_LAUNCHES[k] for k in ("wgmma", "simt")}


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


def _padded(x):
    """x [W, d] with zero columns up to the next multiple of TILE_D."""
    tile = pairwise_gram.TILE_D
    return torch.nn.functional.pad(x, (0, -x.shape[1] % tile)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 10, 25, 64])
def test_gram_unaligned_leaf_chain_equals_packed_on_card(cuda, W):
    """The per-leaf chain (robust_sync.tree_gram's) over unaligned leaves,
    which take the predicated loads, equals one call over the leaves packed
    and padded to TILE_D, which takes TMA: both paths give the same unit
    partials bit for bit."""
    gen = torch.Generator(cuda).manual_seed(W)
    leaves = [torch.randn((W, d), device=cuda, generator=gen) * 3
              for d in (10, 100_003, 4097, 6144)]
    reset_launches()
    acc = None
    for leaf in leaves:
        acc = pairwise_gram.pairwise_gram(leaf, acc)
    packed = pairwise_gram.pairwise_gram(torch.cat([_padded(x) for x in leaves], dim=1))
    assert torch.equal(acc, packed)
    assert VARIANT_LAUNCHES["gram_ldg"] == 3 and VARIANT_LAUNCHES["gram_tma"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 10, 25, 64])
def test_gram_chain_repeat_symmetry_on_card(cuda, W):
    gen = torch.Generator(cuda).manual_seed(100 + W)
    tile = pairwise_gram.TILE_D
    x = torch.randn((W, 7 * tile + 1000), device=cuda, generator=gen)
    seed = torch.randn((W, W), device=cuda, generator=gen)
    seed = seed + seed.T
    whole = pairwise_gram.pairwise_gram(x, seed)
    assert torch.equal(whole, pairwise_gram.pairwise_gram(x, seed))
    assert torch.equal(whole, whole.T)
    acc = seed
    for lo, hi in [(0, tile), (tile, 4 * tile), (4 * tile, x.shape[1])]:
        acc = pairwise_gram.pairwise_gram(x[:, lo:hi].contiguous(), acc)
    assert torch.equal(acc, whole)


@pytest.mark.cuda
def test_gram_cut_at_every_unit_boundary_on_card(cuda):
    """X[10, 26,624], a rank's slice in the 4-rank sync: 13 one-unit calls
    chained equal one call."""
    tile = pairwise_gram.TILE_D
    x = torch.randn((10, 26_624), device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    acc = None
    for lo in range(0, x.shape[1], tile):
        acc = pairwise_gram.pairwise_gram(x[:, lo:lo + tile].contiguous(), acc)
    assert torch.equal(acc, pairwise_gram.pairwise_gram(x))


@pytest.mark.cuda
def test_gram_variant_rule_on_card(cuda):
    """16-byte aligned rows take TMA; the same values 4 bytes off a 16-byte
    boundary, or d % 4 != 0, take the predicated loads; the bits agree."""
    gen = torch.Generator(cuda).manual_seed(5)
    x = torch.randn((10, 4096), device=cuda, generator=gen)
    buf = torch.empty(10 * 4096 + 1, device=cuda)
    off = buf[1:].view(10, 4096)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    reset_launches()
    got = pairwise_gram.pairwise_gram(x)
    assert VARIANT_LAUNCHES["gram_tma"] == 1 and VARIANT_LAUNCHES["gram_ldg"] == 0
    assert torch.equal(pairwise_gram.pairwise_gram(off), got)
    assert VARIANT_LAUNCHES["gram_ldg"] == 1
    ragged = x[:, :4094].contiguous()
    pairwise_gram.pairwise_gram(ragged)
    assert VARIANT_LAUNCHES == {"wgmma": 0, "simt": 0, "gram_tma": 1, "gram_ldg": 2}
    assert LAUNCHES["pairwise_gram"] == 3


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
    q = torch.randn((1, 64, 4, 64), device=cuda)
    flash_attention(q, q[:, :, :2].contiguous(), q[:, :, 2:].contiguous(), block_q=64,
                    block_kv=64)
    assert LAUNCHES == {"bucket_mix": 1, "pairwise_gram": 1, "cwise_median": 1,
                        "cwise_trimmed_mean": 1, "residual_norms": 1, "cclip_fused_iter": 1,
                        "cclip_combine": 1, "flash_attention": 1}


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn((5, 4096), device=cuda)
    with pytest.raises(TypeError):
        cwise_median.cwise_median(x.double())
    with pytest.raises(ValueError):
        pairwise_gram.pairwise_gram(x.T)
    with pytest.raises(ValueError):
        bucket_mix.bucket_mix(torch.full((1, 5), 0.2, device=cuda), x.cpu())


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
    # the fused v' is the combine's fmaf chain, and the norms repeat
    assert torch.equal(v_new, cclip_combine(x, v, lam))
    assert torch.equal(r2, cclip_fused_iter(x, v, lam)[1])


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
    for call in (lambda: residual_norms(x.double(), lam.double()),
                 lambda: residual_norms(x, center=v.half()),
                 lambda: cclip_fused_iter(x, v.double(), lam),
                 lambda: cclip_combine(x.bfloat16(), v, lam)):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: residual_norms(x, center=v.cpu()),
                 lambda: residual_norms(x[:, ::2], center=v[::2]),
                 lambda: cclip_fused_iter(x, v.cpu(), lam),
                 lambda: cclip_combine(x, v, lam.cpu())):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [65, 128])
@pytest.mark.parametrize("d", [106_496, 4097])
def test_wide_kernels_match_plain_on_card(cuda, W, d):
    """Above 64 workers every aggregation kernel runs (the Gram through one
    launch per pair of 32-row groups) and agrees with its plain version:
    CM/TM bit for bit, the rest at the reference's tolerances."""
    gen = torch.Generator(cuda).manual_seed(W + d)
    x = torch.randn((W, d), device=cuda, generator=gen) * 3
    for rows in (W // 2, 65):
        m = torch.rand((rows, W), device=cuda, generator=gen)
        m = m / m.sum(1, keepdim=True)
        torch.testing.assert_close(bucket_mix.bucket_mix(m, x), ref.bucket_mix(m, x),
                                   rtol=1e-5, atol=1e-4)
    scale = x.abs() @ x.abs().T
    reset_launches()
    g = pairwise_gram.pairwise_gram(x)
    groups = len(pairwise_gram.row_groups(W))
    assert LAUNCHES["pairwise_gram"] == groups * (groups - 1) // 2
    assert torch.equal(g, g.T) and torch.equal(g, pairwise_gram.pairwise_gram(x))
    assert bool(((g - ref.pairwise_gram(x)).abs() <= 1e-3 + 1e-5 * scale).all())
    assert torch.equal(cwise_median.cwise_median(x), ref.cwise_median(x))
    for b in (1, (W - 1) // 2):
        assert torch.equal(trimmed_mean.cwise_trimmed_mean(x, b), ref.cwise_trimmed_mean(x, b))
    c = torch.softmax(torch.randn(W, device=cuda, generator=gen), 0)
    v = torch.randn(d, device=cuda, generator=gen)
    lam = torch.rand(W, device=cuda, generator=gen)
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
    # the fused v' is the combine's fmaf chain, and the norms repeat
    assert torch.equal(v_new, cclip_combine(x, v, lam))
    assert torch.equal(r2, cclip_fused_iter(x, v, lam)[1])


@pytest.mark.cuda
def test_wide_gram_chain_bitwise_on_card(cuda):
    """The grouped route at W = 80 chains over 2048-aligned cuts, seeded
    with a symmetric acc, bit for bit, and each call repeats."""
    tile = pairwise_gram.TILE_D
    gen = torch.Generator(cuda).manual_seed(80)
    x = torch.randn((80, 5 * tile + 300), device=cuda, generator=gen)
    seed = torch.randn((80, 80), device=cuda, generator=gen)
    seed = seed + seed.T
    whole = pairwise_gram.pairwise_gram(x, seed)
    assert torch.equal(whole, whole.T) and torch.equal(whole, pairwise_gram.pairwise_gram(x, seed))
    acc = seed
    for lo, hi in [(0, 2 * tile), (2 * tile, 3 * tile), (3 * tile, x.shape[1])]:
        acc = pairwise_gram.pairwise_gram(x[:, lo:hi].contiguous(), acc)
    assert torch.equal(acc, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [129, 200])
def test_selection_past_128_rows_on_card(cuda, W):
    """Past 128 rows the programs spill out of the registers: slower, and
    the same bits."""
    x = torch.randn((W, 3000), device=cuda, generator=torch.Generator(cuda).manual_seed(W))
    assert torch.equal(cwise_median.cwise_median(x), ref.cwise_median(x))
    assert torch.equal(trimmed_mean.cwise_trimmed_mean(x, (W - 1) // 2),
                       ref.cwise_trimmed_mean(x, (W - 1) // 2))


# The selection kernels on both sides of the block-size rule (fitted blocks
# up to 32 rows, 64 threads above) and at its edge, at widths with a ragged
# tail and the path's width
SEL_WS = [1, 2, 3, 5, 13, 27, 32, 33, 65, 128]
SEL_DS = [3, 4097, 100_003, 106_496]


def _trims(W):
    return [b for b in sorted({0, 1, (W - 1) // 2}) if b <= (W - 1) // 2]


@pytest.fixture(scope="module")
def selection_built():
    """Every selection library the tests below load, built in parallel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_all([src for W in SEL_WS for src in cwise_median.sources(W) + [
        s for b in _trims(W) for s in trimmed_mean.sources(W, b)]])


def _plant_specials(x):
    """A copy of ``x`` with a NaN in one row of a column, eight NaN columns
    among one warp's columns and an all-NaN one, columns of mixed +0 / -0
    (alone and among other values), and +-inf (with a NaN in one column)."""
    W, d = x.shape
    x = x.clone()
    nan, inf = float("nan"), float("inf")
    even = torch.arange(W, device=x.device) % 2 == 0
    signed_zeros = torch.where(even, -0.0, 0.0)
    x[W // 2, 7 % d] = nan
    for j in range(8):
        x[(3 * j) % W, (32 + j) % d] = nan
    x[:, 40 % d] = nan
    x[:, 64 % d] = signed_zeros
    x[: (W + 1) // 2, 65 % d] = signed_zeros[: (W + 1) // 2]
    x[0, 96 % d] = inf
    x[W - 1, 97 % d] = -inf
    x[:, 98 % d] = inf
    x[:, 99 % d] = torch.where(even, -inf, inf)
    x[:, 100 % d] = torch.where(torch.arange(W, device=x.device) % 3 == 0, -inf, inf)
    x[W - 1, 100 % d] = nan
    return x


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("W", SEL_WS)
@pytest.mark.parametrize("d", SEL_DS)
def test_selection_bitwise_on_card(cuda, selection_built, W, d):
    """CM and TM (n_trim 0, 1 and the widest band's) give the plain
    version's bits, NaN payloads, signed zeros and infinities included, on
    aligned rows and on the same values in a view whose rows start 4 bytes
    off a 16-byte boundary."""
    gen = torch.Generator(cuda).manual_seed(7 * W + d)
    x = torch.randn((W, d), device=cuda, generator=gen)
    buf = torch.empty(W * d + 1, device=cuda)
    off = buf[1:].view(W, d)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    for inp in (x, _plant_specials(x)):
        off.copy_(inp)
        want = ref.cwise_median(inp)
        for xs in (inp, off):
            assert _same_bits(cwise_median.cwise_median(xs), want)
        for b in _trims(W):
            want = ref.cwise_trimmed_mean(inp, b)
            for xs in (inp, off):
                assert _same_bits(trimmed_mean.cwise_trimmed_mean(xs, b), want)


@pytest.mark.cuda
@pytest.mark.parametrize("W,m", [(10, 5), (25, 13), (10, 1), (3, 2), (53, 27), (70, 20)])
@pytest.mark.parametrize("d", [4097, 100_003])
def test_mix_unaligned_rows_give_the_aligned_bits_on_card(cuda, W, m, d):
    """Rows that are not 16-byte aligned take the predicated loads; each
    column's bits are those of the same column in an aligned call (the
    columns padded to a multiple of 4), and a call repeats bit for bit."""
    gen = torch.Generator(cuda).manual_seed(d + W)
    x = torch.randn((W, d), device=cuda, generator=gen)
    mix = torch.rand((m, W), device=cuda, generator=gen)
    mix = mix / mix.sum(1, keepdim=True)
    got = bucket_mix.bucket_mix(mix, x)
    assert torch.equal(got, bucket_mix.bucket_mix(mix, x))
    padded = torch.nn.functional.pad(x, (0, -d % 4)).contiguous()
    assert torch.equal(got, bucket_mix.bucket_mix(mix, padded)[:, :d])
    buf = torch.empty(W * d + 1, device=cuda)
    off = buf[1:].view(W, d)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    assert torch.equal(got, bucket_mix.bucket_mix(mix, off))
    torch.testing.assert_close(got, ref.bucket_mix(mix, x), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [5, 10, 25, 40, 53])
@pytest.mark.parametrize("d", [4097, 100_003])
def test_norms_unaligned_rows_on_card(cuda, W, d):
    """The predicated-load route of residual_norms, both forms, against the
    plain version, and repeating bit for bit."""
    gen = torch.Generator(cuda).manual_seed(W * d)
    x = torch.randn((W, d), device=cuda, generator=gen) * 3
    c = torch.softmax(torch.randn(W, device=cuda, generator=gen), 0)
    buf = torch.empty(d + 1, device=cuda)
    v = buf[1:]
    v.copy_(torch.randn(d, device=cuda, generator=gen))
    for call, want in ((lambda: residual_norms(x, c), ref.residual_norms(x, c)),
                       (lambda: residual_norms(x, center=v), ref.residual_norms(x, center=v))):
        got = call()
        assert torch.equal(got, call())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_residual_norms_is_one_kernel_and_captures_on_card(cuda):
    """The fold runs in the same launch: one CUDA kernel a call and no
    memset; a CUDA graph of calls (its own ticket counter) replays to the
    eager bits, and eager calls after it still agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(cuda).manual_seed(6)
    x = torch.randn((10, 106_496), device=cuda, generator=gen)
    c = torch.softmax(torch.randn(10, device=cuda, generator=gen), 0)
    want = residual_norms(x, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            residual_norms(x, c)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert sum(e.count for e in kernels) == 5, [(e.key, e.count) for e in kernels]
    assert all("residual_norms" in e.key for e in kernels)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        residual_norms(x, c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [residual_norms(x, c) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
    assert torch.equal(residual_norms(x, c), want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [5, 26, 53])
@pytest.mark.parametrize("d", [4096, 100_003])
@pytest.mark.parametrize("offset", ["xs", "v", "out"])
def test_cclip_fused_unaligned_on_card(cuda, W, d, offset):
    """One of xs, v and v' 4 bytes off 16 (a contiguous slice of a flat
    buffer) takes the predicated loads and stores: the same bits as the call
    on aligned copies (the same columns a thread, summed in the same order),
    v' that of the combine, and nothing written past the d columns."""
    gen = torch.Generator(cuda).manual_seed(W + d)
    x = torch.randn((W, d), device=cuda, generator=gen) * 3
    v = torch.randn(d, device=cuda, generator=gen)
    lam = torch.rand(W, device=cuda, generator=gen)
    want_v, want_r = cclip_fused_iter(x, v, lam)

    def off(t):  # the same values at a base 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, device=cuda)
        got = buf[1:].view(t.shape)
        got.copy_(t)
        assert got.data_ptr() % 16 == 4
        return got

    xs_in, v_in = (off(x), v) if offset == "xs" else (x, off(v) if offset == "v" else v)
    buf = torch.full((d + 2,), 7.0, device=cuda)
    v_out = buf[1:d + 1] if offset == "out" else torch.empty(d, device=cuda)
    r2 = torch.empty(W, device=cuda)
    cclip_fused.launch(xs_in, v_in, lam, v_out, r2)
    assert torch.equal(v_out, want_v) and torch.equal(r2, want_r)
    assert torch.equal(v_out, cclip_combine(x, v, lam))
    torch.testing.assert_close(r2, ref.cclip_fused_iter(x, v, lam)[1], rtol=1e-4, atol=1e-3)
    if offset == "out":
        assert float(buf[0]) == 7.0 and float(buf[-1]) == 7.0


@pytest.mark.cuda
def test_cclip_fused_is_one_kernel_and_captures_on_card(cuda):
    """A fused CCLIP iteration is one launch of the residual-norms kernel
    (the fold inside, no memset); two calls in one CUDA graph (its own
    ticket counter) replay to the eager bits, and eager calls after it
    still agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(cuda).manual_seed(7)
    x = torch.randn((5, 26_624), device=cuda, generator=gen)
    v = torch.randn(26_624, device=cuda, generator=gen)
    lam = torch.rand(5, device=cuda, generator=gen)
    want = cclip_fused_iter(x, v, lam)
    want2 = cclip_fused_iter(x, want[0], lam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cclip_fused_iter(x, v, lam)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert sum(e.count for e in kernels) == 5, [(e.key, e.count) for e in kernels]
    assert all("residual_norms_kernel" in e.key for e in kernels)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cclip_fused_iter(x, v, lam)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        first = cclip_fused_iter(x, v, lam)
        second = cclip_fused_iter(x, first[0], lam)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, expect in zip(first + second, want + want2):
            assert torch.equal(got, expect)
    assert all(torch.equal(a, b) for a, b in zip(cclip_fused_iter(x, v, lam), want))


# fp32 at the reference's 2e-4; bf16 at torch's bf16 default (rtol 1.6e-2,
# atol 1e-5): both sides do fp32 math and round the output to bf16 once
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh,window,q_offset", [
    (2, 64, 64, 4, 4, 32, 0, -1),        # the reference test's cases
    (2, 64, 64, 8, 2, 32, 0, -1),
    (2, 64, 64, 4, 2, 32, 24, -1),
    (2, 32, 128, 4, 4, 32, 0, -1),
    (1, 256, 256, 32, 4, 64, 0, -1),     # tinyllama heads
    (1, 192, 192, 40, 8, 128, 0, -1),    # qwen2.5-14b heads, ragged against the 64-row tile
    (1, 128, 128, 16, 16, 256, 0, -1),   # gemma-7b heads
    (1, 64, 320, 32, 4, 64, 0, -1),      # chunked prefill
    (1, 320, 320, 32, 4, 64, 100, -1),   # sliding window
    (1, 48, 80, 4, 2, 48, 0, -1),        # ragged S and dh
    (1, 64, 128, 4, 2, 32, 0, -8),       # rows before every key
    (1, 64, 128, 4, 2, 32, 8, 200),      # rows past the window's reach
    # edges of the bf16 tensor-core kernel (128-key tiles, 64 at dh 256)
    (1, 1024, 1024, 8, 2, 64, 0, -1),    # several turns of the K/V ring
    (1, 512, 512, 4, 2, 128, 0, -1),
    (1, 512, 512, 4, 4, 256, 0, -1),
    (1, 64, 208, 4, 2, 64, 0, 300),      # Skv not a multiple of the tile: keys past
    (1, 64, 208, 4, 2, 128, 0, 300),     # Skv must be masked, not given p = e^0
    (1, 64, 208, 4, 4, 256, 0, 300),
    (1, 128, 208, 8, 2, 48, 0, 300),     # dh 48 and 32: zero fill in dh
    (1, 256, 256, 8, 2, 32, 0, -1),
    (1, 512, 512, 8, 2, 128, 200, -1),   # window edges inside tiles
    (1, 256, 256, 4, 4, 256, 72, -1),
    (2, 256, 256, 16, 2, 64, 0, -1),     # B = 2, 8 query heads per kv head
    (2, 128, 384, 16, 2, 128, 0, -1),
])
def test_flash_attention_matches_plain_on_card(cuda, dtype, B, Sq, Skv, H, KV, dh, window,
                                               q_offset):
    gen = torch.Generator(cuda).manual_seed(Sq + Skv + dh)
    q = torch.randn((B, Sq, H, dh), device=cuda, generator=gen).to(dtype)
    k = torch.randn((B, Skv, KV, dh), device=cuda, generator=gen).to(dtype)
    v = torch.randn((B, Skv, KV, dh), device=cuda, generator=gen).to(dtype)
    reset_launches()
    got = flash_attention(q, k, v, window=window, block_q=16, block_kv=16, q_offset=q_offset)
    assert LAUNCHES["flash_attention"] == 1
    kind = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert _attention_variants() == {"wgmma": int(kind == "wgmma"), "simt": int(kind == "simt")}
    want = ref.attention(q, k, v, window=window,
                         q_offset=None if q_offset == -1 else q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,window", [(64, 0), (128, 40), (256, 0)])
def test_flash_attention_non_causal_matches_plain_on_card(cuda, dtype, dh, window):
    """causal=False: every key up to Skv = 208 is visible (and, with a window,
    the keys after a row too), so the zeros past Skv in the last tile are
    masked by Skv alone."""
    gen = torch.Generator(cuda).manual_seed(dh + window)
    q = torch.randn((1, 192, 8, dh), device=cuda, generator=gen).to(dtype)
    k = torch.randn((1, 208, 2, dh), device=cuda, generator=gen).to(dtype)
    v = torch.randn((1, 208, 2, dh), device=cuda, generator=gen).to(dtype)
    reset_launches()
    got = flash_attention(q, k, v, causal=False, window=window, block_q=16, block_kv=16)
    kind = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert _attention_variants() == {"wgmma": int(kind == "wgmma"), "simt": int(kind == "simt")}
    want = ref.attention(q, k, v, causal=False, window=window)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
def test_flash_attention_misaligned_bf16_takes_simt(cuda):
    """A bf16 view 2 bytes past a 16-byte boundary is refused by TMA: it takes
    the CUDA-core kernel, at the bf16 tolerance."""
    gen = torch.Generator(cuda).manual_seed(11)
    n = 1 * 128 * 4 * 64
    buf = torch.randn(n + 1, device=cuda, generator=gen).to(torch.bfloat16)
    q = buf[1:].view(1, 128, 4, 64)
    k = torch.randn((1, 128, 2, 64), device=cuda, generator=gen).to(torch.bfloat16)
    v = torch.randn((1, 128, 2, 64), device=cuda, generator=gen).to(torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    reset_launches()
    got = flash_attention(q, k, v, block_q=16, block_kv=16)
    assert LAUNCHES["flash_attention"] == 1 and _attention_variants() == {"wgmma": 0, "simt": 1}
    torch.testing.assert_close(got, ref.attention(q, k, v), rtol=1.6e-2, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.randn((1, 128, 4, 64), device=cuda)  # S = 128: the default blocks divide it
    k = torch.randn((1, 128, 2, 64), device=cuda)
    for call in (lambda: flash_attention(q.half(), k.half(), k.half()),
                 lambda: flash_attention(q.double(), k.double(), k.double()),
                 lambda: flash_attention(q, k.bfloat16(), k)):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: flash_attention(q, k, k, block_q=48),
                 lambda: flash_attention(q, k.cpu(), k),
                 lambda: flash_attention(q.transpose(1, 2), k, k, block_q=4),
                 lambda: flash_attention(torch.randn((1, 128, 4, 320), device=cuda),
                                         torch.randn((1, 128, 2, 320), device=cuda),
                                         torch.randn((1, 128, 2, 320), device=cuda))):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,T,cf", [("olmoe-1b-7b", 128, 1.25), ("olmoe-1b-7b", 128, 0.25),
                                       ("kimi-k2-1t-a32b", 128, 1.25), ("olmoe-full", 512, 1.25)])
def test_moe_layer_repeats_bitwise_and_matches_cpu_on_card(cuda, arch, T, cf):
    """``moe_layer`` in fp32 on the card (no kernel of ours: PyTorch's
    sort, scatter, gather and bmm): two runs give the same bits, and the
    output and aux losses match the CPU route at rtol / atol 1e-5, the drop
    fraction exactly; at smoke width and at OLMoE's full layer width."""
    cfg = (get_config("olmoe-1b-7b") if arch == "olmoe-full" else smoke_config(arch))
    cfg = dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((2, T // 2, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_layer(p, x, cfg)
    pc = tree_map(lambda t: t.to(cuda), p)
    (a, aux), (b, _) = (moe.moe_layer(pc, x.to(cuda), cfg) for _ in range(2))
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), want, rtol=1e-5, atol=1e-5)
    assert float(aux["moe_drop_frac"]) == float(want_aux["moe_drop_frac"])
    for k in ("moe_lb_loss", "moe_z_loss"):
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], rtol=1e-5, atol=1e-5)
