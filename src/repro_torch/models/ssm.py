"""Mamba-2 (SSD, state-space duality) block, chunked scan (port of
``repro/models/ssm.py``).

The minimal SSD algorithm of Dao & Gu (arXiv:2405.21060): the sequence is
split into chunks of length Q; inside a chunk the recurrence is computed in
its dual quadratic (attention-like) form, and the chunk-boundary states are
carried by a loop over the ``S / Q`` chunks (the reference's ``lax.scan``).
The reference writes no Pallas kernel here, and neither does the port: the
contractions are PyTorch ``einsum`` / ``matmul``.

The reference's rounding points are kept: the conv sums its K shifted
products in fp32 in the reference's order and casts back; the train path
applies silu in the model dtype after that cast, the decode path in fp32
before it; ``dt``, ``A``, the scan and the skip ``D`` are fp32. Each
three-operand ``einsum`` of the reference is written as two products in a
fixed order, so the intermediates stay bounded (``Lm`` alone is 268 MB in
fp32 at Jamba's width) and the order does not hang on whether
``opt_einsum`` is installed. ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` is (``torch.nn.functional.softplus`` returns ``x``
above 20).

Decode is the O(1) recurrent update of a ``{"conv": [B, K-1, C],
"ssm": [B, H, P, N]}`` state.

On a model axis (``ax``, ``models/parallel.py``) both run on a rank's
blocks of its H/T heads: ``in_proj``'s z | x | B | C | dt columns with z,
x and dt of its heads and B / C whole, the conv's x | B | C channels alike,
the per-head leaves, the gated norm's scale and ``out_proj``'s rows
(``sharding.compute_shardings``); a decode cache holds the heads' state
and the x channels of the conv ring beside the whole B / C channels. The
z | x and dt products take the stream through ``copy_in``; B and C are
computed whole from the stream and pass, after their conv and silu,
through a ``copy_in`` of their own, so their weights get whole, equal
gradients and the stream's gradient counts them once. The scan runs on
the rank's heads as it is. The gated RMSNorm all-reduces the fp32 sum of
squares of the rank's d_inner / T columns (``ModelAxis.sum_across``) and
divides by the whole d_inner, and the output is ``project_out`` of the
rank's rows. Without ``ax`` the one-device code runs as it did.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init, rmsnorm


# ------------------------------------------------------------------ params
def init_ssm(generator: torch.Generator, cfg, device) -> dict:
    """The reference's leaves; ``A_log``, ``D`` and ``dt_bias`` are fp32 in
    any model dtype."""
    d, din = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    dtype = getattr(torch, cfg.dtype)
    conv_ch = din + 2 * n  # x, B, C (one group)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, d, 2 * din + 2 * n + h, dtype, device),  # z,x,B,C,dt
        "conv_w": _normal(generator, (conv_ch, cfg.conv_kernel), 0.1, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm_scale": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, din, d, dtype, device),
    }


# ---------------------------------------------------------------- helpers
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum_exp(da: torch.Tensor) -> torch.Tensor:
    """da: [..., L] -> lower-triangular decay matrix exp(sum_{j<k<=i} da_k).

    L[i, j] = exp(cumsum_i - cumsum_j) for j <= i, else 0. The masked
    entries are ``exp`` of a positive sum, as in the reference: where it
    overflows, the gradient through the ``where`` is NaN in both packages.
    """
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    L = da.shape[-1]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=da.device))
    return torch.where(tri, torch.exp(diff), 0.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as K shifted multiply-adds. x: [B, S, C]; w: [C, K].

    Summed in fp32 as the reference sums, ``b + ((((0 + t0) + t1) + t2) +
    t3)``, then cast back to ``x.dtype``; ``F.conv1d`` would sum in
    another order."""
    K = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    w32 = w.float()
    out = b.float()[None, None, :] + sum(xp[:, k:k + S, :] * w32[:, k][None, None, :]
                                         for k in range(K))
    return out.to(x.dtype)


# ------------------------------------------------------------------- train
def ssd_scan(x, dt, A, B_, C_, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: [B,S,H,P]; dt: [B,S,H]; A: [H] (negative);
    B_, C_: [B,S,G,N] (G=1). Returns y: [B,S,H,P] fp32 and the final state
    [B,H,P,N] fp32."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = B_[:, :, 0].reshape(Bsz, nc, Q, N).float()  # one group, broadcast over heads
    Cc = C_[:, :, 0].reshape(Bsz, nc, Q, N).float()

    da_t = (dtc * A[None, None, None, :]).movedim(-1, -2)  # [B,c,H,Q]
    cs = torch.cumsum(da_t, dim=-1)
    xdt = xc * dtc[..., None]  # input scaled by dt, [B,c,Q,H,P]

    # intra-chunk (quadratic / dual form): (scores * Lm) against xdt over s
    Lm = _segsum_exp(da_t)  # [B,c,H,Q,Q]
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # [B,c,Q,Q]
    weights = scores[:, :, None] * Lm  # [B,c,H,l,s]
    del Lm
    y_diag = torch.einsum("bchls,bcshp->bclhp", weights, xdt)
    del weights

    # chunk-boundary states: (decay * xdt) against B over s
    decay_to_end = torch.exp(cs[..., -1:] - cs)  # [B,c,H,Q]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, decay_to_end.movedim(-1, -2)[..., None] * xdt)

    # inter-chunk recurrence; h_prevs[c] is the state entering chunk c
    chunk_decay = torch.exp(cs[..., -1])  # [B,c,H]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # [B,c,H,P,N]

    # contribution of the carried-in state: (C against h over n) * decay
    decay_in = torch.exp(cs).movedim(-1, -2)  # [B,c,Q,H]
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, h_prevs) * decay_in[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, h


def _widths(p) -> Tuple[int, int]:
    """``(d_inner, heads)`` of the block ``p`` holds: the whole layer's, or
    on a model axis its heads'."""
    return p["norm_scale"].shape[-1], p["A_log"].shape[-1]


def _gated_out(p, gated: torch.Tensor, cfg, ax=None) -> torch.Tensor:
    """The gated RMSNorm over d_inner and the out projection; on a model
    axis from the rank's columns: their fp32 sum of squares summed over the
    group, the output ``project_out``'s sum of the ranks' rows."""
    norm = {"scale": p["norm_scale"]}
    if ax is None:
        return rmsnorm(norm, gated, cfg.norm_eps) @ p["out_proj"]
    out = rmsnorm(norm, gated, cfg.norm_eps, ax.sum_across, cfg.d_inner)
    return ax.project_out(out, p["out_proj"])


def ssm_layer(p, hidden: torch.Tensor, cfg, ax=None) -> torch.Tensor:
    """Full Mamba-2 block (train). hidden: [B, S, D]. On a model axis
    ``ax`` ``p`` is this rank's blocks (module docstring)."""
    B, S, D = hidden.shape
    n, P = cfg.ssm_state, cfg.ssm_head_dim
    din, h = _widths(p)

    if ax is None:
        zxbcdt = hidden @ p["in_proj"]
        z, xbc, dt_raw = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)
    else:  # z | x and dt from the stream's copy; B | C whole from the stream
        w, hc = p["in_proj"], ax.copy_in(hidden)
        zx = hc @ w[..., :2 * din]
        dt_raw = hc @ w[..., 2 * din + 2 * n:]
        z, x_raw = torch.split(zx, [din, din], dim=-1)
        xbc = torch.cat([x_raw, hidden @ w[..., 2 * din:2 * din + 2 * n]], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))  # silu in the model dtype
    x, B_, C_ = torch.split(xbc, [din, n, n], dim=-1)
    if ax is not None:  # B | C whole: their gradient summed over the group
        B_, C_ = torch.split(ax.copy_in(xbc[..., din:]), [n, n], dim=-1)

    dt = softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]
    A = -torch.exp(p["A_log"])  # [H]
    xh = x.reshape(B, S, h, P)
    y, _ = ssd_scan(xh, dt, A, B_[:, :, None, :], C_[:, :, None, :], cfg.ssm_chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, din).to(hidden.dtype)

    # gated RMSNorm + out projection
    return _gated_out(p, y * F.silu(z), cfg, ax)


# ------------------------------------------------------------------ decode
def init_ssm_cache(batch: int, cfg, dtype, device) -> dict:
    """``conv``: the last K-1 conv inputs in the model dtype; ``ssm``: the
    fp32 state."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def decode_ssm(p, hidden: torch.Tensor, cache, cfg, ax=None) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step. hidden: [B, 1, D]. Returns ([B, 1, D], new
    cache); the cache passed in is left as it was. On a model axis ``ax``
    ``p`` and ``cache`` are this rank's blocks (module docstring): its
    heads' state, its x channels and the whole B / C channels of the conv
    ring."""
    B = hidden.shape[0]
    n, P = cfg.ssm_state, cfg.ssm_head_dim
    din, h = _widths(p)

    zxbcdt = hidden[:, 0] @ p["in_proj"]  # [B, ...]
    z, xbc, dt_raw = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)

    # conv ring: the state holds the previous K-1 inputs
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B,K,C]
    conv_out = torch.einsum("bkc,ck->bc", conv_in.float(), p["conv_w"].float())
    # silu in fp32, before the cast (the train path casts first)
    xbc_t = F.silu(conv_out + p["conv_b"].float()).to(hidden.dtype)
    new_conv = conv_in[:, 1:]

    x, B_, C_ = torch.split(xbc_t, [din, n, n], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])  # [B,H]

    xh = x.reshape(B, h, P).float()
    # h' = dA h + dt x (outer) B ; y = h' . C + D x
    upd = (dt[:, :, None] * xh)[..., None] * B_.float()[:, None, None, :]
    new_state = cache["ssm"] * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_.float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, din).to(hidden.dtype)

    out = _gated_out(p, y * F.silu(z), cfg, ax)[:, None, :]
    return out, {"conv": new_conv, "ssm": new_state}
