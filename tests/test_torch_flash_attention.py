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
