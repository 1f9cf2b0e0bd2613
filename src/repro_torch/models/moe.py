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

Along a model axis (``ax``, ``models/parallel.py``; the reference's
expert axis over ``model``) rank m of the group holds experts ``[m E/T,
(m+1) E/T)``. Routing is whole on every rank: the router, top-k, the
dispatch sort, the capacity (from all T tokens), the drops and the aux
losses come from the stream, which is the same bits on every rank, so
every rank makes the same choices. A rank dispatches only the kept
assignments of its experts into a ``[E/T, C + 1, D]`` buffer (the others
to the spare slot), sums its gated outputs over K in fp32, and one
all-reduce of that ``[T, D]`` fp32 partial over the group, rounded once to
``x.dtype``, gives one device's fp32 sum over K and its one rounding. The
gates reach the combine through a ``copy_in`` of their own, so the router
gets whole, equal gradients; the aux losses take the gates before it and
count once. Shared experts follow, split as the MLP where
``ax.moe_shared``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

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


#: where ``recorded_routes`` is open, the list it yields
_ROUTES: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def recorded_routes():
    """Every routing ``_route`` makes inside the block, in call order (a
    period recomputed in the backward routes again): each MoE layer's
    top-k experts ``[T, K]`` and kept assignments ``[T*K]`` in dispatch
    order, on their device. For the tests and the smoke run, which hold
    every rank's routing against one device's."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def _route(p, xt: torch.Tensor, cfg):
    """Routing, the same on one device and on every rank of a model group:
    the fp32 router logits ``[T, E]``, the softmax gates, the renormalised
    top-k gates and experts ``[T, K]`` (a stable descending sort), and the
    dispatch: the stable sort of the ``T*K`` assignments by expert
    (``order``, ``sorted_e``), each one's slot ``pos`` within its expert and
    whether it fits the capacity ``C`` (``keep``)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    C = expert_capacity(T, cfg)
    logits = (xt.float() @ p["router"]).float()  # [T, E]
    gates_all = torch.softmax(logits, dim=-1)
    gate_sorted, idx_sorted = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gate_topk, idx_topk = gate_sorted[:, :K], idx_sorted[:, :K]  # [T, K]
    gate_topk = gate_topk / torch.sum(gate_topk, dim=-1, keepdim=True)

    # ---- sort-based dispatch
    flat_e = idx_topk.reshape(-1)  # [T*K]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _bincount(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=xt.device) - starts[sorted_e]
    keep = pos < C
    if _ROUTES is not None:
        _ROUTES.append((idx_topk.detach(), keep.detach()))
    return dict(logits=logits, gates_all=gates_all, gate_topk=gate_topk, idx_topk=idx_topk,
                order=order, sorted_e=sorted_e, pos=pos, keep=keep, C=C)


def _experts(p, buf: torch.Tensor, cfg) -> torch.Tensor:
    """The batched expert products over the stacked weights: ``[e, C, D]``
    in, ``[e, C, D]`` out."""
    if "w_gate" in p:
        gate = torch.bmm(buf, p["w_gate"])
        act_g = F.silu(gate) if cfg.mlp_kind == "swiglu" else F.gelu(gate, approximate="tanh")
        act = act_g * torch.bmm(buf, p["w_up"])
    else:
        act = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
    return torch.bmm(act, p["w_down"])


def _aux(r, E: int, T: int, K: int) -> Dict[str, torch.Tensor]:
    """Switch load balance ``E * sum_e f_e P_e`` with ``f_e`` the fraction
    of tokens whose TOP-1 expert is e (the reference's note), the router
    z-loss and the fraction of assignments dropped."""
    top1 = _bincount(r["idx_topk"][:, 0].contiguous(), E)
    f_e = top1.float() / T
    p_e = torch.mean(r["gates_all"], dim=0)
    return {
        "moe_lb_loss": E * torch.sum(f_e * p_e),
        "moe_z_loss": torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1))),
        "moe_drop_frac": 1.0 - torch.sum(r["keep"]) / (T * K),
    }


def moe_layer(p, x: torch.Tensor, cfg, ax=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], aux dict with losses). On a model
    axis ``ax`` that splits the experts (``ax.moe``), ``p`` holds this
    rank's experts and the output is the same on every rank of the group
    (module docstring)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(T, D)
    r = _route(p, xt, cfg)
    out = _routed_experts(p, xt, r, cfg, ax if ax is not None and ax.moe else None)
    shared_ax = ax if ax is not None and ax.moe_shared else None
    for i in range(cfg.n_shared_experts):  # always on, kimi-style
        out = out + mlp_block(p[f"shared_{i}"], xt, cfg.mlp_kind, shared_ax)
    return out.reshape(B, S, D), _aux(r, E, T, K)


def _routed_experts(p, xt: torch.Tensor, r, cfg, ax=None) -> torch.Tensor:
    """The routed experts' output ``[T, D]``: the experts ``p`` holds, ``[e0,
    e0 + n)`` (all E on one device; this rank's E/T on ``ax``), on their
    kept assignments; the gated outputs summed over K in fp32 (as one
    device's 16-bit sum accumulates) and, on ``ax``, all-reduced over the
    group, then rounded once to ``x.dtype``."""
    T, D = xt.shape
    K, C = cfg.experts_per_token, r["C"]
    n = p["w_up"].shape[0]
    e0 = 0 if ax is None else ax.index * n
    order, sorted_e = r["order"], r["sorted_e"]
    mine = r["keep"] & (sorted_e >= e0) & (sorted_e < e0 + n)
    local_e = torch.where(mine, sorted_e - e0, 0)
    write_pos = torch.where(mine, r["pos"], C)  # slot C takes every other assignment
    tok_of = order // K
    flat_g = r["gate_topk"].reshape(-1)
    if ax is not None:  # whole gate and input gradients, all-reduced
        flat_g, xt = ax.copy_in(flat_g), ax.copy_in(xt)

    buf = torch.zeros((n, C + 1, D), dtype=xt.dtype, device=xt.device)
    buf = torch.index_put(buf, (local_e, write_pos), xt[tok_of])[:, :C]
    out_buf = _experts(p, buf, cfg)  # [n, C, D]

    # ---- gather + gate-combine back to tokens, in a fixed order
    gathered = out_buf[local_e, torch.clamp(write_pos, max=C - 1)]  # [T*K, D]
    gated = gathered * flat_g[order].to(xt.dtype)[:, None]
    # where, not a 0/1 product: another rank's or a dropped assignment
    # reads an arbitrary row, whose inf or NaN a product would carry
    gated = torch.where(mine[:, None], gated, torch.zeros((), dtype=xt.dtype, device=xt.device))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * K, device=xt.device)
    acc = torch.promote_types(xt.dtype, torch.float32)
    out = torch.sum(gated[inverse].reshape(T, K, D), dim=1, dtype=acc)
    return (out if ax is None else ax.reduce_out(out)).to(xt.dtype)
