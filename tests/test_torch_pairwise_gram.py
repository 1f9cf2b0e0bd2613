"""The order of summation of the port's ``pairwise_gram`` kernel, emulated on
the CPU and held against the reference.

``csrc/pairwise_gram.cu`` cannot run here, so this file writes its
arithmetic out in fp32 torch (``emulate``): every 2048-column unit is split
over the CS CTAs of a cluster (2048 / CS columns each; CS = 4 for W <= 24,
else 2); in a CTA, lane l of a
block pair's L lanes adds x_i[c] x_j[c] with fmaf over its columns
(``4 (l + L g) + k`` of each 128-column stage) in ascending order; the L
lanes' sums are added by recursive halving (lane l with l + L/2, then
l + L/4, ...); the CS CTAs' sums in rank order; then ``acc`` is folded with
the unit partials in unit order. The 8 x 8 register tiles do not change
that order: each accumulator is its own chain. fmaf is emulated by
rounding the exact product plus the accumulator through fp64 to fp32, which
equals fmaf except where the fp64 rounding lands on an fp32 tie (about one
operation in 2^29).

The emulation is held against the reference kernel (interpret mode, as
tests/test_kernels.py runs it) within the reference's tolerance, and its
chain over 2048-aligned cuts against one call, bit for bit. The index
arithmetic of the kernel (the halving's element map, the pairs each thread
sums over the cluster, the fold's groups) is replayed in Python. The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_gram import pairwise_gram as rgram
from repro_torch.kernels import ref
from repro_torch.kernels.pairwise_gram import (GROUP_ROWS, MAX_ROWS, TILE_D, grouped_gram,
                                               row_groups, variant)

STAGE, FOLD_PAIRS = 128, 4  # GR_C, GR_FOLD_PAIRS of the source


def lanes(W: int) -> int:
    """``gram_lanes``: lanes per 8 x 8 block pair."""
    nb = -(-W // 8)
    NB = nb * (nb + 1) // 2
    return 32 if NB <= 7 else 16 if NB <= 14 else 8 if NB <= 28 else 4


def cluster(L: int) -> int:
    """``GrShape<L>::CS``: CTAs a cluster, each a slice of a unit."""
    return 4 if L == 32 else 2


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def unit_partials(x: torch.Tensor) -> torch.Tensor:
    """[W, d] -> [n_units, W, W]: each unit's partial in the kernel's order."""
    W, d = x.shape
    n, L = -(-d // TILE_D), lanes(W)
    CS = cluster(L)
    SLICE = TILE_D // CS
    xp = torch.zeros((W, n * TILE_D), dtype=torch.float32)
    xp[:, :d] = x
    # a unit's column: rank * SLICE + stage * 128 + 4 (gi L + l) + k
    v = xp.view(W, n, CS, SLICE // STAGE, STAGE // 4 // L, L, 4)
    seq = v.permute(1, 2, 5, 3, 4, 6, 0).reshape(n, CS, L, SLICE // L, W)
    acc = torch.zeros((n, CS, L, W, W), dtype=torch.float32)
    for t in range(seq.shape[3]):  # each lane's columns in ascending order
        col = seq[:, :, :, t]
        acc = _fma(col[..., :, None], col[..., None, :], acc)
    while acc.shape[2] > 1:  # recursive halving: l with l + L/2, then l + L/4, ...
        h = acc.shape[2] // 2
        acc = acc[:, :, :h] + acc[:, :, h:]
    part = acc[:, 0, 0]
    for r in range(1, CS):  # the cluster's CTAs in rank order
        part = part + acc[:, r, 0]
    return part


def emulate(x: torch.Tensor, acc=None) -> torch.Tensor:
    W = x.shape[0]
    g = torch.zeros((W, W), dtype=torch.float32) if acc is None else acc.clone()
    for part in unit_partials(x):  # one add per unit, in unit order
        g = g + part
    return g


def _x(W, d, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((W, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("W,d", [(1, 4096), (8, 300), (10, 6000), (25, 3 * 2048 + 5),
                                 (33, 2049), (64, 4097)])
def test_emulation_matches_reference_kernel(W, d):
    x = _x(W, d, seed=W)
    want = np.asarray(rgram(jnp.asarray(x)))
    got = emulate(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("W", [1, 10, 25, 64])
def test_emulation_with_acc_matches_reference_kernel(W):
    x = _x(W, 5000, seed=100 + W)
    a = _x(W, W, seed=200 + W)
    a = a + a.T
    want = np.asarray(rgram(jnp.asarray(x), jnp.asarray(a)))
    got = emulate(torch.tensor(x), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, ref.pairwise_gram(torch.tensor(x), torch.tensor(a)).numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("W,d,cuts", [(1, 3 * 2048 + 7, [2048]),
                                      (10, 5 * 2048 + 1000, [2048, 3 * 2048]),
                                      (25, 4 * 2048 + 3, [2048, 2 * 2048, 3 * 2048]),
                                      (64, 2 * 2048 + 1, [2048])])
def test_emulated_chain_equals_one_call_bitwise(W, d, cuts):
    """2048-aligned cuts of an unaligned d: each unit's partial depends only
    on its own columns, and the fold is one add per unit in order."""
    x = torch.tensor(_x(W, d, seed=W + d))
    whole = emulate(x)
    acc = None
    for lo, hi in zip([0] + cuts, cuts + [d]):
        acc = emulate(x[:, lo:hi].contiguous(), acc)
    assert torch.equal(acc, whole)


def test_emulated_unaligned_leaves_equal_packed_bitwise():
    """The per-leaf chain over unaligned leaves equals one call over the
    leaves padded to 2048 columns and packed (the card test's claim)."""
    leaves = [torch.tensor(_x(10, d, seed=d)) for d in (10, 3000, 4097)]
    acc = None
    for leaf in leaves:
        acc = emulate(leaf, acc)
    packed = torch.cat([torch.nn.functional.pad(t, (0, -t.shape[1] % TILE_D))
                        for t in leaves], dim=1)
    assert torch.equal(acc, emulate(packed))


@pytest.mark.parametrize("L", [4, 8, 16, 32])
def test_halving_leaves_the_tree_sum_at_its_elements(L):
    """The kernel's ``halve<L>`` step by step (send / keep per lane, one
    shuffle per kept value): lane l ends with elements k + l (64 / L) of the
    lanes' sum, each added in the tree the emulation uses."""
    v = torch.tensor(_x(L, 64, seed=L))
    regs = [list(v[l]) for l in range(L)]
    o, n = L // 2, 32
    while o >= 1:
        new = []
        for l in range(L):
            hi = (l & o) != 0
            partner = regs[l ^ o]
            # keep my half; the partner (the other half's lane) sends its copy of it
            new.append([(regs[l][k + n] if hi else regs[l][k])
                        + (partner[k + n] if hi else partner[k]) for k in range(n)])
        regs = new
        o, n = o // 2, n // 2
    tree = v.clone()
    while tree.shape[0] > 1:
        tree = tree[:tree.shape[0] // 2] + tree[tree.shape[0] // 2:]
    for l in range(L):
        for k in range(64 // L):
            assert torch.equal(regs[l][k], tree[0, k + l * (64 // L)])


@pytest.mark.parametrize("W", list(range(1, 65)))
def test_cluster_sum_and_fold_cover_every_pair_once(W):
    """The source's index arithmetic: each pair's partial is summed over the
    cluster by one thread of one CTA (at most MAXE = 32 / L a thread) from
    its place in the 8 x 8 tile of its block pair, and the fold's groups of
    4 cover the pairs once whatever the grid."""
    nb = -(-W // 8)
    NB, L = nb * (nb + 1) // 2, lanes(W)
    CS = cluster(L)
    ncw = -(-NB * L // 32)
    P = W * (W + 1) // 2
    blocks = [(I, J) for I in range(nb) for J in range(I, nb)]
    assert ncw * 32 + 32 <= (192 if L == 16 else 256)  # GrShape<L>::THREADS
    seen = {}
    for rank in range(CS):
        for tid in range(32 * ncw):
            for k in range(32 // L):
                p = rank + CS * (tid + 32 * ncw * k)
                if p < P:
                    seen[p] = seen.get(p, 0) + 1
    assert sorted(seen) == list(range(P)) and set(seen.values()) == {1}
    pairs = [(i, j) for i in range(W) for j in range(i, W)]
    offs = [blocks.index((i // 8, j // 8)) * 64 + (i % 8) * 8 + j % 8 for i, j in pairs]
    assert len(set(offs)) == P and max(offs) < NB * 64
    F = -(-P // FOLD_PAIRS)
    for total in (4, 52, 208, 264):
        fe = min(F, total)
        groups = sorted(g for f in range(fe) for g in range(f, F, fe))
        assert groups == list(range(F))


_FP32_RULE = [(4096, 256, "gram_tma"), (106_496, 0, "gram_tma"), (4097, 256, "gram_ldg"),
              (10, 256, "gram_ldg"), (4096, 260, "gram_ldg"), (4096, 264, "gram_ldg"),
              (2 ** 31, 0, "gram_ldg")]
# 16-bit rows: 16-byte rows need d % 8 == 0, so d = 4100 (fp32's TMA) and a
# base 8 bytes off take the predicated loads
_X16_RULE = [(4096, 256, "gram_tma"), (106_496, 0, "gram_tma"), (4100, 256, "gram_ldg"),
             (4096, 264, "gram_ldg"), (4097, 256, "gram_ldg"), (2 ** 31, 0, "gram_ldg")]


@pytest.mark.parametrize("dtype,d,ptr,want", [
    pytest.param(torch.float32, d, ptr, want, id=f"{d}-{ptr}-{want}")
    for d, ptr, want in _FP32_RULE + [(4100, 256, "gram_tma")]] + [
    pytest.param(dt, d, ptr, want, id=f"{str(dt)[6:]}-{d}-{ptr}-{want}")
    for dt in (torch.bfloat16, torch.float16) for d, ptr, want in _X16_RULE])
def test_variant_rule(dtype, d, ptr, want):
    """TMA needs 16-byte aligned rows (base and row stride: d a multiple of
    4 fp32 or 8 16-bit elements) and a 32-bit column coordinate; anything
    else takes the predicated loads."""
    assert variant(d, ptr, dtype) == want


# ------------------------------------- more than 64 rows: the grouped route
# On the card, W > 64 goes through ``grouped_gram``: groups of at most 32
# rows, one kernel call for each pair of groups on their rows stacked. Here
# the calls are the emulation above.
@pytest.mark.parametrize("W", [65, 128])
def test_grouped_route_matches_reference_kernel(W):
    """Within the reference's rtol 1e-5 / atol 1e-3, the rtol taken against
    |X| |X|^T as on the card (tests/test_torch_cuda.py): fp32 rounding of a
    dot product scales with sum_k |x_ik x_jk|, and among the 8,256 pairs at
    W = 128 a few cancel to values of ~5 whose rounding in either order
    exceeds 1e-5 of the value. The error against an fp64 Gram is no larger
    than the reference's."""
    x = _x(W, 2 * 2048 + 5, seed=W)
    a = _x(W, W, seed=300 + W)
    a = a + a.T
    scale = np.abs(x).astype(np.float64) @ np.abs(x).T.astype(np.float64)
    exact = x.astype(np.float64) @ x.T.astype(np.float64)
    for acc in (None, a):
        want = np.asarray(rgram(jnp.asarray(x), None if acc is None else jnp.asarray(acc)))
        got = grouped_gram(torch.tensor(x), None if acc is None else torch.tensor(acc),
                           emulate).numpy()
        assert (np.abs(got - want) <= 1e-3 + 1e-5 * scale).all()
        np.testing.assert_array_equal(got, got.T)
        if acc is None:
            assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("W,cuts", [(65, [2048]), (128, [2048, 2 * 2048])])
def test_grouped_chain_equals_one_call_bitwise(W, cuts):
    """2048-aligned cuts: each group pair's call chains as the kernel does,
    and every block is read from the same pair's call in both."""
    d = 3 * 2048 + 7
    x = torch.tensor(_x(W, d, seed=W + d))
    whole = grouped_gram(x, None, emulate)
    acc = None
    for lo, hi in zip([0] + cuts, cuts + [d]):
        acc = grouped_gram(x[:, lo:hi].contiguous(), acc, emulate)
    assert torch.equal(acc, whole)
    assert torch.equal(grouped_gram(x, None, emulate), whole)


@pytest.mark.parametrize("W", [65, 96, 97, 128, 129, 300])
def test_row_groups_fit_one_call_per_pair(W):
    """Groups cover the rows once, in order, at most GROUP_ROWS each, so a
    pair stacked is at most MAX_ROWS, one call of the kernel."""
    groups = row_groups(W)
    assert groups[0][0] == 0 and groups[-1][1] == W
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(groups[:-1], groups[1:]))
    sizes = [hi - lo for lo, hi in groups]
    assert max(sizes) <= GROUP_ROWS and max(sizes) - min(sizes) <= 1
    assert 2 * GROUP_ROWS == MAX_ROWS
