"""Decoder LM (port of ``repro/models/transformer.py``), dense family.

A model is a repeating *pattern* of layers (``cfg.pattern_``), each layer a
(mixer, ff) pair. This slice ports the dense pattern ``(("attn", "mlp"),)``;
the SSM, MoE, codebook (audio) and prefix-embedding (VLM) paths raise
``NotImplementedError`` (``ROADMAP.md`` Queue 1).

Parameters keep the reference's tree: ``params["blocks"][str(i)]`` holds
layer ``i`` of the pattern with every leaf stacked on a leading period axis
``[n_periods, ...]``, so a parameter tree maps one to one onto the
reference's. The reference's ``lax.scan`` over periods is a Python loop
over that axis here; the decode cache keeps the same axis.

Entry points:
  init_params(cfg, generator, device)         -> params tree
  forward(params, cfg, tokens, ...)           -> logits, aux
  loss_fn(params, cfg, batch)                 -> scalar loss, aux (autograd
                                                 differentiates it)
  init_cache(cfg, batch, seq_len, device)     -> decode cache
  decode_step(params, cfg, cache, token, pos) -> logits, new cache
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (dense_init, embed_init, init_mlp_block,
                                       init_rmsnorm, mlp_block, rmsnorm)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

_DENSE = (("attn", "mlp"),)


def _check_dense(cfg) -> None:
    if cfg.pattern_ != _DENSE or cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense pattern {_DENSE} only; SSM, MoE, "
            "hybrid and audio (codebook) models are queued in ROADMAP.md, Queue 1")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ================================================================== params
def _init_layer(generator, cfg, device) -> Dict[str, Any]:
    dtype = _dtype(cfg)
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, device),
        "mixer": attn_mod.init_attention(generator, cfg, device),
        "norm2": init_rmsnorm(cfg.d_model, dtype, device),
        "ff": init_mlp_block(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device),
    }


def init_params(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (see ``layers``), laid out
    as the reference's tree."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: Dict[str, Any] = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                                  dtype, dev)}
    periods = [{"0": _init_layer(generator, cfg, dev)} for _ in range(cfg.n_periods)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *periods)
    del periods
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev)
    return params


# ================================================================== embed
def embed_tokens(params, cfg, tokens) -> torch.Tensor:
    _check_dense(cfg)
    return params["embed"][tokens]


def unembed(params, cfg, h) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    logits = logits.float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ================================================================= forward
def _period(tree, p: int):
    """The parameters (or cache) of period ``p``: views into the stacked leaves."""
    return tree_map(lambda x: x[p], tree)


def _periods(tree, n_periods: int):
    """Every period's parameters, views from one ``unbind`` a stacked leaf:
    the backward pass then writes each stacked leaf's gradient once, where
    ``x[p]`` would add a zero-filled leaf-sized gradient for every period."""
    leaves, treedef = tree_flatten(tree)
    split = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [s[p] for s in split]) for p in range(n_periods)]


def forward_hidden(
    params,
    cfg,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone only: final-norm hidden states [B, S, D] + aux (empty for
    the dense family). Callers choose which positions to unembed."""
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (VLM / audio conditioning) are "
                                  "queued in ROADMAP.md, Queue 1")
    h = embed_tokens(params, cfg, tokens)
    S = h.shape[1]
    if positions is None:
        positions = torch.arange(S, device=h.device)[None, :]
    for period in _periods(params["blocks"], cfg.n_periods):
        lp = period["0"]
        h = h + attn_mod.attention(lp["mixer"], rmsnorm(lp["norm1"], h, cfg.norm_eps), cfg,
                                   positions)
        h = h + mlp_block(lp["ff"], rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg.mlp_kind)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, {}


def forward(
    params,
    cfg,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train forward: full-sequence fp32 logits [B, S, V]. tokens: [B, S]."""
    h, aux = forward_hidden(params, cfg, tokens, prefix_embeds, positions)
    return unembed(params, cfg, h), aux


def loss_fn(params, cfg, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy. batch: dict with "tokens", "labels"; labels
    use -100 as the ignore index. Every op is out of place, so autograd
    gives the reference's ``jax.grad`` (``tests/test_torch_train.py``)."""
    logits, aux = forward(params, cfg, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"))
    labels = batch["labels"]
    valid = labels != -100
    labels_c = torch.clamp(labels, min=0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_c[..., None].long())[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    aux = dict(aux)
    aux["ce_loss"] = loss
    return loss, aux


# ================================================================== decode
def cache_length(cfg, seq_len: int) -> int:
    if cfg.long_context == "state":
        return 0
    if cfg.long_context == "window" and seq_len > cfg.long_context_window:
        return cfg.long_context_window
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, device=None) -> Dict[str, Any]:
    """Stacked decode cache: one entry per pattern index, leading period axis."""
    _check_dense(cfg)
    dev = resolve_device(device)
    L = cache_length(cfg, seq_len)
    one = attn_mod.init_kv_cache(batch, max(L, 1), cfg, _dtype(cfg), dev)
    return {"0": tree_map(lambda x: x[None].repeat((cfg.n_periods,) + (1,) * x.dim()), one)}


def decode_step(params, cfg, cache, token, position: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode. token: [B] int; position: int. Returns (logits
    [B, V], new cache); the cache passed in is left as it was."""
    _check_dense(cfg)
    h = params["embed"][token][:, None, :]
    new_cache = []
    for p in range(cfg.n_periods):
        lp = _period(params["blocks"], p)["0"]
        x = rmsnorm(lp["norm1"], h, cfg.norm_eps)
        out, nc = attn_mod.decode_attention(lp["mixer"], x, _period(cache, p)["0"], cfg,
                                            position)
        new_cache.append(nc)
        h = h + out
        h = h + mlp_block(lp["ff"], rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg.mlp_kind)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params, cfg, h)  # [B, 1, V]
    return logits[:, 0], {"0": tree_map(lambda *xs: torch.stack(xs), *new_cache)}
