"""Attention: GQA with RoPE, optional QKV bias / sliding window (port of
``repro/models/attention.py``).

- ``xla``: plain einsum softmax attention (small S).
- ``blockwise``: memory-O(S * block) online-softmax attention, a loop over
  query blocks and, inside it, over KV blocks; the same recurrence as the
  reference's (``lax.map`` / ``lax.scan`` there). Agrees with ``xla`` up to
  fp32 accumulation order.
- The hand-written kernel ``repro_torch.kernels.flash_attention`` computes
  the same function; as in the reference, no model path calls it.

Both implementations keep the reference's rounding points: the QKᵀ einsum
runs in the input dtype and is cast to fp32 before the scale, and ``xla``
casts the probabilities back to the input dtype before the second einsum.

Decode path: single-token query against a (possibly windowed) ring-buffer
KV cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


# ------------------------------------------------------------------ params
def init_attention(generator, cfg, device) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dtype = getattr(torch, cfg.dtype)
    p = {
        "wq": dense_init(generator, d, h * dh, dtype, device),
        "wk": dense_init(generator, d, kv * dh, dtype, device),
        "wv": dense_init(generator, d, kv * dh, dtype, device),
        "wo": dense_init(generator, h * dh, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, dh)
    k = k.reshape(B, S, kv, dh)
    v = v.reshape(B, S, kv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KV, dh] -> [B, S, H, dh] by repeating each kv head."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


# -------------------------------------------------------------- full (xla)
def _attn_xla(q, k, v, scale, causal: bool, window: int):
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# -------------------------------------------------- blockwise (flash-style)
def _divisor_block(S: int, target: int) -> int:
    """Largest block size <= target dividing S (handles prefix-extended
    sequence lengths like 4096 + n_prefix that break power-of-two tiling)."""
    b = min(target, S)
    while S % b:
        b -= 1
    return b


def _attn_blockwise(q, k, v, scale, causal: bool, window: int, bq: int, bkv: int):
    """Online-softmax attention. q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh]. Every
    KV block is visited, masked or not, as in the reference."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bq = _divisor_block(Sq, bq)
    bkv = _divisor_block(Sk, bkv)
    rep = H // KV
    qpos_base = Sk - Sq  # causal offset (decode prefix)
    dev = q.device

    outs = []
    for qi in range(Sq // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq]  # [B, bq, H, dh]
        qpos = qpos_base + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, dh), dtype=torch.float32, device=dev)
        for ki in range(Sk // bkv):
            k_blk = k[:, ki * bkv:(ki + 1) * bkv]
            v_blk = v[:, ki * bkv:(ki + 1) * bkv]
            kpos = ki * bkv + torch.arange(bkv, device=dev)
            logits = torch.einsum("bqhd,bkhd->bhqk", q_blk,
                                  torch.repeat_interleave(k_blk, rep, dim=2)).float() * scale
            mask = _mask(qpos, kpos, causal, window)
            logits = torch.where(mask[None, None], logits, NEG_INF)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, torch.repeat_interleave(v_blk, rep, dim=2).float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # [B, bq, H, dh]
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------- forward
def attention(p, x, cfg, positions, impl: Optional[str] = None) -> torch.Tensor:
    """Self-attention over the full sequence (train / prefill)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    scale = cfg.head_dim_ ** -0.5
    impl = impl or cfg.attention_impl
    if impl == "auto":
        impl = "blockwise" if x.shape[1] > 2048 else "xla"
    if impl == "xla":
        out = _attn_xla(q, k, v, scale, True, cfg.sliding_window)
    elif impl == "blockwise":
        out = _attn_blockwise(
            q, k, v, scale, True, cfg.sliding_window, cfg.attn_block_q, cfg.attn_block_kv
        )
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim_) @ p["wo"]


# ----------------------------------------------------------------- decode
@dataclasses.dataclass
class KVCacheSpec:
    """Static description of one attention layer's cache."""

    length: int  # cache capacity (window or full seq)


def init_kv_cache(batch: int, length: int, cfg, dtype, device) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
    }


def decode_attention(p, x, cache, cfg, position: int) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: [B, 1, D]; cache k/v: [B, L, KV, dh];
    position: int, the absolute position of the new token.

    The cache is a ring buffer of capacity L: slot = position % L. Attention
    masks out unwritten (future-of-window) slots via per-slot positions.
    Returns a new cache; the one passed in is left as it was.
    """
    B = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim_
    L = cache["k"].shape[1]
    pos_arr = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_arr)

    slot = position % L
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    # absolute position held in each ring slot (<= position, stride L)
    idx = torch.arange(L, device=x.device)
    slot_pos = position - torch.remainder(position - idx, L)
    valid = slot_pos >= 0
    if cfg.sliding_window > 0:
        valid &= slot_pos > position - cfg.sliding_window

    scale = dh**-0.5
    k_e = _expand_kv(k, h)
    v_e = _expand_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_e).float() * scale
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_e)
    out = out.reshape(B, 1, h * dh) @ p["wo"]
    return out, {"k": k, "v": v}
