"""Plain PyTorch versions of the ported kernels (``attention`` is
``flash_attention``'s), and the vector-space oracles of the composed
aggregators (``rfa_aggregate``, ``cclip_aggregate``).

Each is the function its CUDA kernel computes, written with PyTorch
operators. The wrappers use them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds every kernel against them on the card. CM and TM
run the same selection program as the kernels, so they agree bitwise.

Like the kernels, the plain mix and Gram give a column's result
independently of the columns around it: the mix sums its W terms one
elementwise operation at a time, and the Gram sums fixed ``TILE_D``-column
tiles and folds them in tile order from ``acc``. So the per-leaf engine
(a chain of calls, one per leaf) and the packed engine (one call on the
2048-aligned buffer) agree bit for bit on the CPU as on the card, which a
BLAS product does not promise.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.selection_network import median_select, trimmed_mean_select


#: columns per tile of the Gram's sum (``TILE_D`` of ``pairwise_gram.py``)
GRAM_TILE = 2048


def bucket_mix(mix: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Apply the mixing operator: ``[m, W] @ [W, d] -> [m, d]`` fp32, summing
    ``w = 0 .. W-1`` in order."""
    m32, x32 = mix.float(), xs.float()
    out = m32[:, :1] * x32[:1]
    for w in range(1, x32.shape[0]):
        out = out + m32[:, w:w + 1] * x32[w:w + 1]
    return out


def pairwise_gram(xs: torch.Tensor, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Worker Gram matrix ``acc + X X^T``: ``[W, d] -> [W, W]`` fp32. Each
    ``GRAM_TILE``-column tile (the last one zero-padded) gives a partial
    Gram; the partials are added to ``acc`` in tile order."""
    W, d = xs.shape
    n_tiles = -(-d // GRAM_TILE)
    tiles = torch.zeros((W, n_tiles * GRAM_TILE), dtype=torch.float32, device=xs.device)
    tiles[:, :d] = xs
    tiles = tiles.view(W, n_tiles, GRAM_TILE).transpose(0, 1)  # [n_tiles, W, TILE]
    parts = torch.stack([(tiles[:, i:i + 1] * tiles).sum(-1) for i in range(W)], dim=1)
    gram = torch.zeros((W, W), dtype=torch.float32, device=xs.device) if acc is None \
        else acc.float()
    for part in parts:
        gram = gram + part
    return gram


def cwise_median(xs: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the worker axis: ``[W, d] -> [d]`` fp32."""
    return median_select(xs.float())


def cwise_trimmed_mean(xs: torch.Tensor, n_trim: int) -> torch.Tensor:
    """Mean of the sorted ``[n_trim, W - n_trim)`` band: ``[W, d] -> [d]`` fp32."""
    return trimmed_mean_select(xs.float(), n_trim)


def residual_norms(xs: torch.Tensor, coeffs: Optional[torch.Tensor] = None, *,
                   center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-worker residual sq-norms ``||x_i - v||^2`` -> ``[W]`` fp32, with
    ``v = coeffs^T X`` or the explicit row ``center``; exactly one of the two."""
    if (coeffs is None) == (center is None):
        raise ValueError("provide exactly one of coeffs / center")
    x32 = xs.float()
    v = coeffs.float() @ x32 if center is None else center.float()
    return torch.sum((x32 - v[None, :]).square_(), dim=1)  # in place: one [W, d] temporary


def cclip_combine(xs: torch.Tensor, v: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """One centered-clipping update ``v + mean_i lam_i (x_i - v)`` -> ``[d]`` fp32."""
    x32, v32 = xs.float(), v.float()
    return v32 + torch.mean((x32 - v32[None, :]).mul_(lam.float()[:, None]), dim=0)


def cclip_fused_iter(xs: torch.Tensor, v: torch.Tensor, lam: torch.Tensor):
    """The update and the residual norms against it: ``(v' [d], [W])`` fp32."""
    v_new = cclip_combine(xs, v, lam)
    return v_new, residual_norms(xs, center=v_new)


# ------------------------------------------------- composed aggregator refs
def cclip_aggregate(xs: torch.Tensor, tau: float, n_iters: int = 3,
                    eps: float = 1e-12) -> torch.Tensor:
    """Full CCLIP in vector space (oracle for ``ops.cclip_aggregate``)."""
    x32 = xs.float()
    v = torch.mean(x32, dim=0)
    for _ in range(n_iters):
        norms = torch.sqrt(torch.sum(torch.square(x32 - v[None, :]), dim=1) + eps)
        lam = torch.clamp(tau / norms, max=1.0)
        v = cclip_combine(x32, v, lam)
    return v


def rfa_aggregate(xs: torch.Tensor, n_iters: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """Smoothed Weiszfeld in vector space (oracle for ``ops.rfa_aggregate``)."""
    x32 = xs.float()
    n = xs.shape[0]
    c = torch.full((n,), 1.0 / n, dtype=torch.float32, device=xs.device)
    for _ in range(n_iters):
        r = torch.sqrt(residual_norms(x32, c) + eps**2)
        w = 1.0 / r
        c = w / torch.sum(w)
    return c @ x32


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              window: int = 0, q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``flash_attention``. q: [B,Sq,H,dh]; k,v: [B,Skv,KV,dh]
    -> [B,Sq,H,dh] in q's dtype, fp32 math (fp64 for fp64 inputs, which is
    how ``chip_smoke.py`` takes an exact yardstick). Query row i sits at position
    ``q_offset + i`` (``None`` -> ``Skv - Sq``); head h reads kv head
    ``h // (H // KV)``. Masked logits are -1e30, so a row with no visible
    key gets the uniform softmax: the mean of V over all keys."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    off = Skv - Sq if q_offset is None else q_offset
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * dh ** -0.5
    qpos = off + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    return out.to(q.dtype)
