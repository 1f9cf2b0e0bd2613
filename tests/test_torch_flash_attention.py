"""The port's ``flash_attention`` entry point held against the reference's.

On the CPU the port's wrapper takes its plain version (``ref.attention``);
the reference runs its Pallas kernel in interpret mode, as
tests/test_kernels.py does. The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as rflash
from repro.models.attention import _attn_blockwise as r_attn_blockwise
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import _attn_blockwise


def _qkv(B, Sq, Skv, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, dh)).astype(np.float32))


def _both(q, k, v, **kw):
    want = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    return got, np.asarray(want)


# the four cases of tests/test_kernels.py, at its tolerance
@pytest.mark.parametrize("Sq,Skv,H,KV,window", [
    (64, 64, 4, 4, 0),       # MHA causal
    (64, 64, 8, 2, 0),       # GQA
    (64, 64, 4, 2, 24),      # sliding window
    (32, 128, 4, 4, 0),      # chunked prefill (q suffix of kv)
])
def test_flash_attention_matches_reference_kernel(Sq, Skv, H, KV, window):
    q, k, v = _qkv(2, Sq, Skv, H, KV, 32)
    before = LAUNCHES["flash_attention"]
    got, want = _both(q, k, v, window=window, block_q=16, block_kv=32)
    assert got.dtype == torch.float32 and got.shape == (2, Sq, H, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert LAUNCHES["flash_attention"] == before  # the plain version launches nothing


def test_flash_attention_matches_model_blockwise():
    """Entry point == the blockwise impl of the models layer, in both packages."""
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=1)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), block_q=16,
                          block_kv=16)
    blk = _attn_blockwise(torch.tensor(q), torch.tensor(k), torch.tensor(v), 32 ** -0.5,
                          True, 0, 16, 16)
    rblk = r_attn_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 32 ** -0.5,
                            True, 0, 16, 16)
    np.testing.assert_allclose(got.numpy(), blk.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(blk.numpy(), np.asarray(rblk), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Sq,Skv,H,KV,window", [(64, 64, 8, 2, 0), (32, 128, 4, 4, 48)])
def test_flash_attention_bf16_matches_reference(Sq, Skv, H, KV, window):
    """bf16 in and out, fp32 math on both sides: the two outputs are fp32
    results summed in other orders, each rounded to bf16 once, so they may
    differ by one bf16 ulp (2^-8 of the value): rtol 1.6e-2 (torch's bf16
    default), atol 1e-5."""
    q, k, v = _qkv(2, Sq, Skv, H, KV, 64, seed=2)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = rflash(qb, kb, vb, window=window, block_q=16, block_kv=32)
    assert want.dtype == jnp.bfloat16
    tb = [torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (qb, kb, vb)]
    got = flash_attention(*tb, window=window, block_q=16, block_kv=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1e-5)


@pytest.mark.parametrize("q_offset,window", [(-8, 0), (140, 4)])
def test_row_with_no_visible_key_matches_reference(q_offset, window):
    """q_offset -8: rows 0..7 sit before every key; q_offset 140 with window
    4: every row sits past the window's reach (Skv = 128). The reference's
    softmax over all -1e30 logits is uniform: such a row is the mean of V
    over all keys, in the port as in the reference kernel."""
    q, k, v = _qkv(1, 32, 128, 4, 2, 32, seed=3)
    got, want = _both(q, k, v, window=window, block_q=16, block_kv=32, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    n_empty = 8 if q_offset < 0 else 32
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)  # [B, H, dh]: head h reads kv h // 2
    np.testing.assert_allclose(got.numpy()[:, :n_empty],
                               np.broadcast_to(mean_v[:, None], (1, n_empty, 4, 32)),
                               rtol=1e-5, atol=1e-6)


def test_flash_attention_refuses_what_the_reference_refuses():
    q, k, v = _qkv(1, 48, 64, 4, 2, 32)
    with pytest.raises(AssertionError):
        rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_kv=32)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), block_q=32,
                        block_kv=32)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), block_q=16,
                        block_kv=48)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(torch.tensor(q), torch.tensor(k[:, :, :1].repeat(3, 2)),
                        torch.tensor(v[:, :, :1].repeat(3, 2)), block_q=16, block_kv=32)


def test_plain_attention_matches_reference_oracle():
    from repro.kernels import ref as rref

    q, k, v = _qkv(2, 32, 96, 8, 2, 16, seed=4)
    for kw in ({}, {"window": 20}, {"causal": False}, {"q_offset": 10}):
        want = rref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        got = ref.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel (csrc/flash_attention_wgmma.cu), emulated in
# torch on the CPU: its arithmetic, not its code. The kernel itself is held
# against the plain version on the card in tests/test_torch_cuda.py.

def _emulate_wgmma(q, k, v, *, window=0, q_offset=-1, split=True):
    """The wgmma kernel's arithmetic on bf16 ``[B, S, heads, dh]`` tensors:
    bf16 products summed in fp32, the scale dh^-1/2 log2(e) applied after
    the product, ``exp2``, an online rescale per key tile (128 keys, 64 at
    dh > 128), keys past Skv and masked keys at p = 0, and P split into
    P_hi = bf16(p) and P_lo = bf16(p - P_hi) before the two PV products
    (``split=False``: one bf16 P, as FA2 / FA3 / SDPA round it). Rows with no
    visible key get the mean of V; one rounding to bf16 at the end."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset == -1 else q_offset
    bkv = 64 if dh > 128 else 128
    qf = q.float().transpose(1, 2)                                        # [B, H, Sq, dh]
    kf = k.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)      # [B, H, Skv, dh]
    vf = v.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    scale_log2 = dh ** -0.5 * np.log2(np.e)
    qpos = off + torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -np.inf)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, dh))
    for c0 in range(0, Skv, bkv):
        kpos = c0 + torch.arange(bkv)[None, :]
        vis = (kpos < Skv) & (kpos <= qpos)
        if window > 0:
            vis &= kpos > qpos - window
        kt = torch.zeros((B, H, bkv, dh))
        vt = torch.zeros((B, H, bkv, dh))
        n = min(bkv, Skv - c0)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, c0:c0 + n], vf[:, :, c0:c0 + n]
        t = torch.where(vis, (qf @ kt.transpose(-1, -2)) * np.float32(scale_log2), -np.inf)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        mu = torch.where(m_new == -np.inf, 0.0, m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(t - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        o = o * corr + p_hi @ vt
        if split:
            o = o + (p - p_hi).bfloat16().float() @ vt
        m = m_new
    empty = m == -np.inf
    o = torch.where(empty, vf.sum(2, keepdim=True), o)
    l = torch.where(empty, float(Skv), l)
    return (o / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


# the bf16 shapes of tests/test_torch_cuda.py's flash_attention cases
_CARD_BF16 = [
    (2, 64, 64, 8, 2, 32, 0, -1),
    (1, 256, 256, 32, 4, 64, 0, -1),     # tinyllama heads
    (1, 192, 192, 40, 8, 128, 0, -1),    # qwen2.5-14b heads
    (1, 128, 128, 16, 16, 256, 0, -1),   # gemma-7b heads
    (1, 64, 320, 32, 4, 64, 0, -1),      # chunked prefill
    (1, 320, 320, 32, 4, 64, 100, -1),   # sliding window
    (1, 48, 80, 4, 2, 48, 0, -1),        # ragged S and dh
    (1, 64, 208, 4, 2, 64, 0, 300),      # keys past Skv inside the last tile
    (1, 64, 128, 4, 2, 32, 0, -8),       # rows before every key
]
_BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)  # the card test's bf16 tolerance


def _bf16_qkv(B, Sq, Skv, H, KV, dh, seed):
    """The same bf16 inputs for JAX (jnp) and torch."""
    q, k, v = _qkv(B, Sq, Skv, H, KV, dh, seed=seed)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16) for a in jb]
    return jb, tb


@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh,window,q_offset", _CARD_BF16)
def test_wgmma_arithmetic_matches_reference_and_plain(B, Sq, Skv, H, KV, dh, window, q_offset):
    """The split-P arithmetic against the JAX reference kernel (interpret
    mode) and the port's plain version, at the card tolerance."""
    jb, tb = _bf16_qkv(B, Sq, Skv, H, KV, dh, seed=Sq + Skv + dh)
    got = _emulate_wgmma(*tb, window=window, q_offset=q_offset)
    want = rflash(*jb, window=window, block_q=16, block_kv=16, q_offset=q_offset)
    plain = ref.attention(*tb, window=window, q_offset=None if q_offset == -1 else q_offset)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_BF16_TOL)
    torch.testing.assert_close(got, plain, **_BF16_TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh", [(1, 256, 256, 32, 4, 64),
                                               (1, 128, 128, 16, 16, 256)])
def test_single_bf16_p_misses_the_card_tolerance(B, Sq, Skv, H, KV, dh):
    """Negative control, why the kernel splits P: one bf16 P rounds p by up to
    2^-9 relative, far above rtol |out| + atol near outputs close to zero, so
    a few percent of the elements leave the tolerance that the split keeps."""
    _, tb = _bf16_qkv(B, Sq, Skv, H, KV, dh, seed=Sq + Skv + dh)
    plain = ref.attention(*tb).float()
    bound = _BF16_TOL["atol"] + _BF16_TOL["rtol"] * plain.abs()
    single = (_emulate_wgmma(*tb, split=False).float() - plain).abs() > bound
    split = (_emulate_wgmma(*tb).float() - plain).abs() > bound
    assert int(split.sum()) == 0
    assert float(single.float().mean()) > 0.01


@pytest.mark.parametrize("dtype,dh,ptrs,want", [
    (torch.bfloat16, 64, (0, 16, 4096, 256), "wgmma"),
    (torch.bfloat16, 48, (0, 16, 32, 48), "wgmma"),     # dh % 8 == 0: TMA's zero fill
    (torch.bfloat16, 256, (1024, 2048, 0, 16), "wgmma"),
    (torch.bfloat16, 60, (0, 16, 32, 48), "simt"),      # rows not 16-byte strided
    (torch.bfloat16, 64, (0, 18, 32, 48), "simt"),      # a pointer off a 16-byte boundary
    (torch.float32, 64, (0, 16, 32, 48), "simt"),       # fp32 keeps fp32 math
])
def test_variant_rule(dtype, dh, ptrs, want):
    from repro_torch.kernels.flash_attention import variant

    assert variant(dtype, dh, ptrs) == want
