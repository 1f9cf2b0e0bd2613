"""Shared neural-net building blocks (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors; ``init_*`` functions build
them, the apply functions live beside. Compute runs in the config dtype
with fp32 for norms and RoPE, as in the reference.

Initialisers draw from a ``torch.Generator`` on the generator's own device
and move the result to ``device``: a generator on the card draws a
full-width model there in a moment, one on the CPU gives the same numbers
on every machine.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- inits
def _normal(generator: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * scale).to(device=device, dtype=dtype)


def dense_init(generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return _normal(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return _normal(generator, (vocab, d), 0.02, dtype, device)


# ----------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] or [S]. Rotates the interleaved
    pairs (x[..., 0::2], x[..., 1::2]), as the reference does."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)  # [dh/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------- MLP
def init_mlp_block(generator, d: int, f: int, kind: str, dtype, device):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d, f, dtype, device),
            "w_up": dense_init(generator, d, f, dtype, device),
            "w_down": dense_init(generator, f, d, dtype, device),
        }
    if kind == "gelu":
        return {
            "w_up": dense_init(generator, d, f, dtype, device),
            "w_down": dense_init(generator, f, d, dtype, device),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_block(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        act = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        act = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif kind == "gelu":
        act = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(kind)
    return act @ p["w_down"]
