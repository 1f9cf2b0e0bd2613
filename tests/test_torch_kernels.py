"""The port's kernel modules held against the reference's kernels.

On the CPU every wrapper takes its plain PyTorch version; the reference
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does.
CM and TM must agree BIT FOR BIT; mix and Gram at the reference's own
tolerances. The kernels themselves are tested on the card in
tests/test_torch_cuda.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rkernels
from repro.kernels import ops as rops
from repro.kernels import selection_network as rsel
from repro_torch.kernels import LAUNCHES, _build, reset_launches
from repro_torch.kernels import (cclip_combine, cclip_fused, cwise_median, trimmed_mean,
                                 weiszfeld_norms)
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


# ------------------------------------------- more than 64 workers (W > 64)
# The kernels take any W on the card; their plain versions (what the card
# is held to) against the reference's Pallas kernels in interpret mode.
WIDE = [65, 128]


def _wide_case(W, d=300):
    x = _xs((W, d), seed=W)
    v = np.random.default_rng(W + 1).standard_normal(d).astype(np.float32)
    lam = np.random.default_rng(W + 2).uniform(size=W).astype(np.float32)
    c = np.random.default_rng(W + 3).uniform(size=W).astype(np.float32)
    return x, v, lam, c / c.sum()


@pytest.mark.parametrize("W", WIDE)
@pytest.mark.parametrize("m", [None, 65])  # None: W // 2 rows
def test_wide_bucket_mix_matches_reference(W, m):
    x = _xs((W, 300), seed=W)
    rows = W // 2 if m is None else m
    mix = np.random.default_rng(W + rows).uniform(size=(rows, W))
    mix = (mix / mix.sum(1, keepdims=True)).astype(np.float32)
    expect = np.asarray(rkernels.bucket_mix(jnp.asarray(mix), jnp.asarray(x)))
    np.testing.assert_allclose(tops.mix_apply(torch.tensor(mix), torch.tensor(x)).numpy(),
                               expect, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("W", WIDE)
def test_wide_gram_matches_reference(W):
    x, _, _, _ = _wide_case(W)
    acc = _xs((W, W), seed=W + 4)
    acc = acc + acc.T
    np.testing.assert_allclose(
        tops.gram(torch.tensor(x), torch.tensor(acc)).numpy(),
        np.asarray(rkernels.pairwise_gram(jnp.asarray(x), jnp.asarray(acc))),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("W", WIDE)
def test_wide_cm_bitwise(W):
    x, _, _, _ = _wide_case(W)
    np.testing.assert_array_equal(tops.cm_aggregate(torch.tensor(x)).numpy(),
                                  np.asarray(rkernels.cwise_median(jnp.asarray(x))))


# the reference traces one operation per comparator: the bands with the
# shortest programs at W = 128 (n_trim = 1 there takes a minute to trace)
@pytest.mark.parametrize("W,n_trim", [(65, 1), (65, 32), (128, 63)])
def test_wide_tm_bitwise(W, n_trim):
    x, _, _, _ = _wide_case(W)
    np.testing.assert_array_equal(
        tops.tm_aggregate(torch.tensor(x), n_trim).numpy(),
        np.asarray(rkernels.cwise_trimmed_mean(jnp.asarray(x), n_trim)))


@pytest.mark.parametrize("n_trim", [1, 2, 32])
def test_wide_tm_long_band_bitwise_against_a_sort(n_trim):
    """W = 128 with long bands, whose programs take the reference minutes to
    trace: the band of a full sort, summed in rank order in fp32 and scaled
    by the fp32 reciprocal, is what the plain version must give bit for bit."""
    x, _, _, _ = _wide_case(128)
    band = np.sort(x, axis=0)[n_trim:128 - n_trim]
    acc = band[0].copy()
    for row in band[1:]:
        acc = acc + row
    expect = acc * np.float32(tsel.band_scale(len(band)))
    np.testing.assert_array_equal(tops.tm_aggregate(torch.tensor(x), n_trim).numpy(), expect)


@pytest.mark.parametrize("W", WIDE)
def test_wide_norms_and_clip_match_reference(W):
    x, v, lam, c = _wide_case(W)
    xt, vt, lamt, ct = (torch.tensor(a) for a in (x, v, lam, c))
    xj, vj, lamj, cj = (jnp.asarray(a) for a in (x, v, lam, c))
    np.testing.assert_allclose(tops.norms(xt, ct).numpy(),
                               np.asarray(rkernels.residual_norms(xj, cj)), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tops.norms(xt, center=vt).numpy(),
                               np.asarray(rkernels.residual_norms(xj, center=vj)),
                               rtol=1e-4, atol=1e-3)
    v_new, r2 = tops.cclip_iter(xt, vt, lamt)
    v_ref, r2_ref = rkernels.cclip_fused_iter(xj, vj, lamj)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r2.numpy(), np.asarray(r2_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tops.cclip_combine(xt, vt, lamt).numpy(),
                               np.asarray(rkernels.cclip_combine(xj, vj, lamj)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("W,threads", [(1, 256), (5, 256), (31, 256), (32, 256), (33, 64),
                                       (64, 64), (65, 64), (128, 64), (129, 64), (200, 64),
                                       (1000, 64), (2000, 64)])
def test_selection_layout_by_width(W, threads):
    """Every W keeps one column a thread in a register array of W values;
    up to 32 rows the blocks are fitted to the card (256 threads at the
    path's d on 132 SMs), above 32 rows they take 64 threads. The median
    program is written once, on literal indices, in ``sel_program<NANS>``,
    which the NaN-free and the NaN-aware path each run; nothing of the
    template is left."""
    (_, text), = cwise_median.sources(W)
    assert cwise_median.threads_for(W, 106_496, 132) == threads
    assert f"#define SEL_W {W}" in text and "float v[SEL_W];" in text
    assert "@" not in text.replace("@-placeholders", "")
    body = text[text.index("void sel_program("):text.index("float sel_select(")]
    cx = re.findall(r"^    CX\((\d+), (\d+)\)$", body, re.M)
    assert tuple((int(i), int(j)) for i, j in cx) == \
        tsel.selection_program(W, tsel.median_ranks(W))
    assert text.count("    CX(") == len(cx)
    assert text.count("sel_program<false>(v);") == 1
    assert text.count("sel_program<true>(v);") == 1


@pytest.mark.parametrize("d,n_sm,want", [(26_624, 132, 64), (106_496, 132, 224),
                                         (16_777_216, 132, 256), (1, 132, 64),
                                         (106_496, 114, 256)])
def test_fitted_threads(d, n_sm, want):
    """One thread per 4 columns, the fewest threads (a multiple of 32, 64 ..
    256) that cover the columns with one block an SM."""
    threads = _build.fitted_threads(-(-d // 4), n_sm)
    assert threads == want
    assert threads * n_sm * 4 >= d or threads == 256


@pytest.mark.parametrize("W,d,blocks,rows", [(5, 26_624, 26, 8), (25, 16_777_216, 132, 32),
                                             (53, 16_777_216, 132, 64),
                                             (128, 106_496, 104, 64)])
def test_cclip_fused_launch_geometry(W, d, blocks, rows):
    """``cclip_fused_iter`` launches the residual-norms kernel's CLIP form
    with that module's geometry on 132 SMs: 256-thread blocks, at most two
    an SM up to 8 rows and one above, each a contiguous range of 4-column
    groups. Its C entry picks the instance: up to 32 rows the smallest
    chunk of 8 / 16 / 32 rows that holds them all (one pass, the centre
    formed from the rows held), above that passes of 64 rows in chunks of
    16."""
    assert weiszfeld_norms.geometry(W, d, 132) == (256, blocks)
    assert blocks <= 132 * (2 if W <= 8 else 1)
    (_, text), = cclip_fused.sources()
    entry = text[text.index('extern "C" int cclip_fused_launch('):]
    dispatch = re.findall(r"(?:if \(W <= (\d+)\) |else )rn_launch<(\d+), (\d+), RN_CLIP>", entry)
    assert len(dispatch) == 4
    rc, nsub = next((int(rc), int(nsub)) for bound, rc, nsub in dispatch
                    if not bound or W <= int(bound))
    assert rc * nsub == rows
    assert (nsub == 1 and rc >= W) == (W <= 32)


def test_cclip_fused_builds_the_residual_norms_library():
    """The fused CCLIP iteration is the third centre form of
    ``csrc/residual_norms.cu``: its sources are that library's (built
    once), with no ``row_sums.cuh``; the combine alone is ``csrc/cclip.cu``."""
    assert cclip_fused.sources() == weiszfeld_norms.sources()
    (name, text), = cclip_fused.sources()
    assert name == "residual_norms" and "row_sums" not in text
    assert 'extern "C" int cclip_fused_launch(' in text and "#define RN_CLIP 2" in text
    assert "cclip_fused_launch" in weiszfeld_norms._ARGS
    (name, text), = cclip_combine.sources()
    assert name == "cclip" and "row_sums" not in text and "RS_" not in text
    assert "cclip_combine_kernel" in text and "cclip_fused" not in text
    assert not (_build.CSRC / "row_sums.cuh").exists()
    assert not hasattr(cclip_fused, "TILE_D")
