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
from typing import Callable, Optional, Tuple

import torch

from repro_torch.models import parallel
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


def _project_qkv(p, x, cfg, positions, ax=None):
    """q, k, v ``[B, S, heads, dh]`` of ``x``; on a model axis ``ax`` (the
    attention split: ``models/parallel.py``) this rank's head block's q
    heads and the kv heads they read, the head counts read from the
    blocks' widths."""
    B, S, _ = x.shape
    dh = cfg.head_dim_
    xq = x if ax is None else ax.copy_in(x)
    xkv = x if ax is not None and not ax.kv else xq
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if ax is not None and not ax.kv:
        # whole k / v (t a multiple of KV): head block g's q heads share kv
        # head g KV / t; the gradient of the whole k / v is all-reduced,
        # once, on its way to wk / wv
        k0 = ax.head_block * cfg.n_kv_heads // ax.head_groups
        k, v = (ax.copy_in(t)[..., k0 * dh:(k0 + 1) * dh] for t in (k, v))
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
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
def attention(p, x, cfg, positions, impl: Optional[str] = None, ax=None) -> torch.Tensor:
    """Self-attention over the full sequence (train / prefill); on a model
    axis ``ax`` over this rank's head block, the output all-reduced with
    each head block counted once (``ModelAxis.project_heads``)."""
    q, k, v = _project_qkv(p, x, cfg, positions, ax)
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
    out = out.reshape(B, S, q.shape[2] * cfg.head_dim_)
    return out @ p["wo"] if ax is None else ax.project_heads(out, p["wo"])


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


def softmax_values(logits: torch.Tensor, v_e: torch.Tensor, dtype) -> torch.Tensor:
    """One token's attention output ``[B, 1, h, dh]`` from its fp32 logits
    ``[B, h, 1, L]`` (masked) and the values ``[B, L, h, dh]``: the softmax,
    rounded to ``dtype``, times the values."""
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_e)


def decode_attention(p, x, cache, cfg, position: int, span=None,
                     combine: Optional[Callable] = None, ax=None) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: [B, 1, D]; cache k/v: [B, L, KV, dh];
    position: int, the absolute position of the new token.

    The cache is a ring buffer of capacity L: slot = position % L. Attention
    masks out unwritten (future-of-window) slots via per-slot positions.
    Returns a new cache; the one passed in is left as it was.

    A cache sharded over ranks passes its block: ``span = ((l0, l1, L),
    (k0, k1))`` says it holds slots ``l0 .. l1 - 1`` of the L-slot ring and
    kv heads ``k0 .. k1 - 1``, and the new k / v are written only where the
    block holds the slot. ``combine(logits, v_e, dtype)`` then turns the
    block's logits and values into the output of all ``n_heads`` heads
    (``softmax_values``, the default, for a whole cache).

    On a model axis ``ax`` that splits the attention, ``p`` holds this
    rank's compute blocks, its head block's: the token's q heads, and its
    kv heads where the plan splits them (else wk / wv are whole and so are
    k / v), come from them and are gathered into all heads, one block of
    each head group (``parallel.gather_heads``), so one route serves any
    cache block the placement rules give a rank (positions, kv heads or
    neither over the model axis); the output's heads of this rank's block
    (``g H / t ..``) then meet its rows of wo, and the products are summed
    over the model group, each head block once (``ModelAxis.project_heads``:
    replica 0's).
    """
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim_
    if span is None:
        L = cache["k"].shape[1]
        span = ((0, L, L), (0, cfg.n_kv_heads))
    (l0, l1, L), (k0, k1) = span
    pos_arr = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_arr)
    if ax is not None and ax.kv:
        q, k_new, v_new = parallel.gather_heads(ax, q, k_new, v_new)
    elif ax is not None:  # wk / wv whole: k / v hold every kv head already
        (q,) = parallel.gather_heads(ax, q)

    slot = position % L
    k = cache["k"].clone()
    v = cache["v"].clone()
    if l0 <= slot < l1:
        k[:, slot - l0] = k_new[:, 0, k0:k1]
        v[:, slot - l0] = v_new[:, 0, k0:k1]
    rep = H // cfg.n_kv_heads
    q = q[:, :, k0 * rep:k1 * rep]

    # absolute position held in each ring slot (<= position, stride L)
    idx = l0 + torch.arange(l1 - l0, device=x.device)
    slot_pos = position - torch.remainder(position - idx, L)
    valid = slot_pos >= 0
    if cfg.sliding_window > 0:
        valid &= slot_pos > position - cfg.sliding_window

    scale = dh**-0.5
    k_e = _expand_kv(k, q.shape[2])
    v_e = _expand_kv(v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_e).float() * scale
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    out = (combine or softmax_values)(logits, v_e, x.dtype)
    if ax is None:
        return out.reshape(B, 1, H * dh) @ p["wo"], {"k": k, "v": v}
    h = H // ax.head_groups  # this rank's head block's q heads, its rows of wo
    h0 = ax.head_block * h
    out = out[:, :, h0:h0 + h].reshape(B, 1, -1)
    return ax.project_heads(out, p["wo"]), {"k": k, "v": v}
