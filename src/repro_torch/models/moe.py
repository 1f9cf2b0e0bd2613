"""Mixture-of-Experts layer with sort-based capacity dispatch (port of
``repro/models/moe.py``).

1. router top-k per token;
2. flatten the ``T*k`` (token, expert) assignments, sort them by expert id;
3. position-within-expert from bincount prefix sums; assignments beyond the
   per-expert capacity ``C = ceil(k*T/E * capacity_factor)`` are dropped;
4. one batched product over the ``[E, C, D]`` buffer against the stacked
   expert weights ``[E, D, F]`` (``torch.bmm``; the reference's ``einsum``);
5. gather back and combine with the (renormalised) router gates.

Parameters keep the reference's names (``router``, ``w_gate``, ``w_up``,
``w_down``, ``shared_i``), so ``convert.params_from_jax`` carries a MoE tree
across unchanged. The reference's rounding points are kept: the router
product in fp32, the buffer and the expert products in ``x.dtype``, the gate
weight cast to ``x.dtype`` before it multiplies.

Determinism. Three choices keep the layer's bits the same from run to run
on the card, and its choices the reference's:
- top-k is a stable descending sort of the gates, so ties go to the lower
  expert index, as ``jax.lax.top_k`` breaks them (``torch.topk`` does not);
- the dispatch sort is stable, as ``jnp.argsort`` is, so the same
  assignments fall beyond the capacity;
- the combine un-permutes the ``[T*K, D]`` expert outputs to ``[T, K, D]``
  and sums over K in one reduction, where the reference's
  ``.at[tok_of].add`` would be an atomic ``index_add_`` on the card.
Dropped assignments are written to a spare slot ``C`` of a ``[E, C + 1, D]``
buffer that is cut off (the reference's scatter ``mode="drop"``).

Aux losses: the Switch load-balance loss on the top-1 counts, the router
z-loss, and the fraction of assignments dropped.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init, init_mlp_block, mlp_block


def init_moe(generator: torch.Generator, cfg, device=None) -> Dict[str, torch.Tensor]:
    """Random MoE parameters drawn from ``generator``: the fp32 router
    ``[D, E]``, the stacked expert weights ``[E, D, F]`` / ``[E, F, D]`` and
    ``cfg.n_shared_experts`` always-on MLPs."""
    dev = resolve_device(device)
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.d_ff_expert or cfg.d_ff
    dtype = getattr(torch, cfg.dtype)

    def stacked(d_in, d_out):
        return torch.stack([dense_init(generator, d_in, d_out, dtype, dev) for _ in range(e)])

    p = {
        "router": dense_init(generator, d, e, torch.float32, dev, scale=0.02),
        "w_up": stacked(d, fe),
        "w_down": stacked(fe, d),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = stacked(d, fe)
    for i in range(cfg.n_shared_experts):
        p[f"shared_{i}"] = init_mlp_block(generator, d, fe, cfg.mlp_kind, dtype, dev)
    return p


def _bincount(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``0 <= idx < n``, without
    the host sync ``bincount`` makes on the card to size its output."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def expert_capacity(n_tokens: int, cfg) -> int:
    c = math.ceil(cfg.experts_per_token * n_tokens / cfg.n_experts * cfg.capacity_factor)
    return max(8, min(c, n_tokens))


def moe_layer(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], aux dict with losses)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    C = expert_capacity(T, cfg)
    xt = x.reshape(T, D)
    dev = x.device

    logits = (xt.float() @ p["router"]).float()  # [T, E]
    gates_all = torch.softmax(logits, dim=-1)
    gate_sorted, idx_sorted = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gate_topk, idx_topk = gate_sorted[:, :K], idx_sorted[:, :K]  # [T, K]
    gate_topk = gate_topk / torch.sum(gate_topk, dim=-1, keepdim=True)

    # ---- sort-based dispatch
    flat_e = idx_topk.reshape(-1)  # [T*K]
    flat_g = gate_topk.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _bincount(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = pos < C
    write_pos = torch.where(keep, pos, C)  # slot C takes the dropped ones
    tok_of = order // K

    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=dev)
    buf = torch.index_put(buf, (sorted_e, write_pos), xt[tok_of])[:, :C]

    # ---- expert compute (batched products over the stacked weights)
    if "w_gate" in p:
        gate = torch.bmm(buf, p["w_gate"])
        act_g = F.silu(gate) if cfg.mlp_kind == "swiglu" else F.gelu(gate, approximate="tanh")
        act = act_g * torch.bmm(buf, p["w_up"])
    else:
        act = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
    out_buf = torch.bmm(act, p["w_down"])  # [E, C, D]

    # ---- gather + gate-combine back to tokens, in a fixed order
    gathered = out_buf[sorted_e, torch.clamp(write_pos, max=C - 1)]  # [T*K, D]
    gathered = gathered * (keep * flat_g[order]).to(x.dtype)[:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * K, device=dev)
    out = torch.sum(gathered[inverse].reshape(T, K, D), dim=1)

    # ---- shared experts (always on, kimi-style)
    for i in range(cfg.n_shared_experts):
        out = out + mlp_block(p[f"shared_{i}"], xt, cfg.mlp_kind)

    # ---- aux losses: Switch load balance E * sum_e f_e P_e with f_e the
    # fraction of tokens whose TOP-1 expert is e (the reference's note)
    top1 = _bincount(idx_topk[:, 0].contiguous(), E)
    f_e = top1.float() / T
    p_e = torch.mean(gates_all, dim=0)
    lb_loss = E * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - torch.sum(keep) / (T * K)
    aux = {
        "moe_lb_loss": lb_loss,
        "moe_z_loss": z_loss,
        "moe_drop_frac": dropped,
    }
    return out.reshape(B, S, D), aux
