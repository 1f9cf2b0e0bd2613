"""Decoder LM (port of ``repro/models/transformer.py``): every family of
the reference.

A model is a repeating *pattern* of layers (``cfg.pattern_``), each layer a
(mixer, ff) pair with mixer in {attn, ssm} and ff in {mlp, moe, none}:

  dense   pattern [(attn, mlp)]
  moe     pattern [(attn, moe)]            (``models/moe.py``)
  ssm     pattern [(ssm, none)]            (``models/ssm.py``)
  hybrid  Jamba's period of attn / ssm mixers and moe / mlp ffs
  vlm     a dense LM fed stub patch embeddings as a prefix
  audio   MusicGen: K codebook embeddings summed, K output heads

A MoE layer's aux losses are summed over layers from fp32 zeros, and
``loss_fn`` adds ``router_aux_coef * lb + router_z_coef * z`` to the
cross-entropy, as the reference does; a model without MoE layers has an
empty aux. An ``ff = "none"`` layer has no ``norm2`` and no feed-forward.

Parameters keep the reference's tree: ``params["blocks"][str(i)]`` holds
layer ``i`` of the pattern with every leaf stacked on a leading period axis
``[n_periods, ...]``, so a parameter tree maps one to one onto the
reference's. The reference's ``lax.scan`` over periods is a Python loop
over that axis here (each period recomputed in the backward for
``cfg.remat == "full"``, as the reference's ``jax.checkpoint``); the decode
cache keeps the same axis (a KV cache for an attention layer, an SSM state
for an SSM layer).

Codebooks (``cfg.n_codebooks = K``): tokens are ``[B, K, S]`` (``[B, K]``
in decode), the embeddings ``[K, V, D]`` are summed over the codebooks, the
heads ``[K, D, V]`` give logits ``[B, S, K, V]``. Prefix embeddings
(``[B, n_prefix, D]``) go before the tokens, in the model dtype, with
positions over the whole length, and are cut off after the final norm.

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
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, init_mlp_block,
                                       init_rmsnorm, mlp_block, rmsnorm)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_specs, tree_unflatten


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack(*xs: torch.Tensor) -> torch.Tensor:
    """The period axis: a view for one period (no copy of a full-width
    layer), else a stack."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


# ================================================================== params
def _init_layer(generator, mixer: str, ff: str, cfg, device) -> Dict[str, Any]:
    dtype = _dtype(cfg)
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, device)}
    if mixer == "attn":
        p["mixer"] = attn_mod.init_attention(generator, cfg, device)
    elif mixer == "ssm":
        p["mixer"] = ssm_mod.init_ssm(generator, cfg, device)
    else:
        raise ValueError(mixer)
    if ff != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
        if ff == "mlp":
            p["ff"] = init_mlp_block(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype,
                                     device)
        elif ff == "moe":
            p["ff"] = moe_mod.init_moe(generator, cfg, device)
        else:
            raise ValueError(ff)
    return p


def init_params(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (see ``layers``), laid out
    as the reference's tree. Each pattern index's periods are drawn and
    stacked before the next index's, so no more than one index's layers
    exist twice."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    K = cfg.n_codebooks
    params: Dict[str, Any] = {}
    if K:
        params["embed"] = torch.stack([embed_init(generator, cfg.vocab_size, cfg.d_model,
                                                  dtype, dev) for _ in range(K)])  # [K, V, D]
    else:
        params["embed"] = embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, dev)
    params["blocks"] = {}
    for i, (mixer, ff) in enumerate(cfg.pattern_):
        layers = [_init_layer(generator, mixer, ff, cfg, dev) for _ in range(cfg.n_periods)]
        params["blocks"][str(i)] = tree_map(_stack, *layers)
        del layers
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        if K:
            params["lm_head"] = torch.stack([dense_init(generator, cfg.d_model, cfg.vocab_size,
                                                        dtype, dev) for _ in range(K)])
        else:
            params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev)
    return params


def params_shape(cfg) -> Dict[str, Any]:
    """The ``TensorSpec`` tree of ``init_params(cfg, ...)``, built on fake
    tensors that allocate nothing (a full-width model in a moment), as the
    reference's ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return tree_specs(init_params(cfg, torch.Generator(), device="cpu"))


# ================================================================== embed
def embed_tokens(params, cfg, tokens, ax=None) -> torch.Tensor:
    """tokens: [B, S] -> [B, S, D]; codebook tokens [B, K, S] (or [B, K] in
    decode) sum the K tables' rows. On a model axis ``ax`` that splits the
    vocab, from this rank's rows (``parallel.embed_rows``)."""
    if ax is not None and ax.vocab:
        return parallel.embed_rows(ax, params["embed"], tokens, cfg.n_codebooks)
    if cfg.n_codebooks:
        embed = params["embed"]
        return torch.stack([embed[k][tokens[:, k]] for k in range(cfg.n_codebooks)]).sum(0)
    return params["embed"][tokens]


def _head_form(cfg) -> str:
    return "books" if cfg.n_codebooks else ("tied" if cfg.tie_embeddings else "head")


def unembed(params, cfg, h, ax=None) -> torch.Tensor:
    """fp32 logits ``[B, S, V]`` (``[B, S, K, V]`` for codebooks) of the
    stream ``h``, softcapped. On a model axis ``ax`` that splits the vocab
    (a forward without grad), from this rank's vocab block of the head,
    the blocks' logits gathered into all V on every rank
    (``parallel.gather_vocab``)."""
    form = _head_form(cfg)
    w = params["embed"] if form == "tied" else params["lm_head"]
    logits = parallel._local_logits(form, h, w).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if ax is not None and ax.vocab:
        logits = parallel.gather_vocab(ax, logits)
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


def _feed_forward(lp, h, ff: str, cfg, ax=None):
    """``h`` plus layer ``lp``'s feed-forward ``ff``, and the MoE layer's aux
    (or ``None``); an MLP over ``ax`` where it splits d_ff, a MoE layer's
    experts over ``ax`` where it splits them."""
    if ff == "none":
        return h, None
    x = rmsnorm(lp["norm2"], h, cfg.norm_eps)
    if ff == "moe":
        moe_ax = ax if ax is not None and ax.moe else None
        out, aux = moe_mod.moe_layer(lp["ff"], x, cfg, ax=moe_ax)
        return h + out, aux
    return h + mlp_block(lp["ff"], x, cfg.mlp_kind, ax if ax is not None and ax.mlp else None), None


def _has_moe(cfg) -> bool:
    return any(ff == "moe" for _, ff in cfg.pattern_)


def _run_period(period, h, aux, cfg, positions, ax=None):
    """One period, every layer of ``cfg.pattern_``: ``(h, aux)`` after it,
    ``aux`` the MoE layers' losses summed so far (the reference's
    ``period_body`` carry). On a model axis ``ax`` the attention, MLP,
    MoE and SSM layers it splits run on this rank's compute blocks."""
    for i, (mixer, ff) in enumerate(cfg.pattern_):
        lp = period[str(i)]
        x = rmsnorm(lp["norm1"], h, cfg.norm_eps)
        if mixer == "attn":
            h = h + attn_mod.attention(lp["mixer"], x, cfg, positions,
                                       ax=ax if ax is not None and ax.attn else None)
        else:
            h = h + ssm_mod.ssm_layer(lp["mixer"], x, cfg,
                                      ax=ax if ax is not None and ax.ssm else None)
        h, layer_aux = _feed_forward(lp, h, ff, cfg, ax)
        if layer_aux is not None:
            aux = {k: aux[k] + v for k, v in layer_aux.items()}
    return h, aux


def forward_hidden(
    params,
    cfg,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    ax=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone only: final-norm hidden states [B, S, D] of the token
    positions + aux (the MoE layers' losses summed over layers; empty for a
    model without MoE). Callers choose which positions to unembed.

    ``cfg.remat == "full"`` runs each period through a non-reentrant
    ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint(period_body)``: the backward keeps each period's input
    and recomputes the period (all its layers, MoE routing and aux
    included) when it reaches it. The recompute runs the forward's ops, so
    the loss and gradients are those of ``remat="none"`` bit for bit. The
    training forward checkpoints because its embedded input requires grad;
    a forward whose input does not (grad disabled, or parameters without
    grad, as in the serving prefill) enters no checkpoint and runs the ops
    of ``remat="none"``.

    ``ax`` (a ``parallel.ModelAxis``, training over a mesh whose model axis
    has more than one rank) runs the forward on this rank's compute blocks
    of ``params`` (``models/parallel.py``); the returned stream is the
    same on every rank of the model group. A recomputed period replays its
    all-reduces in the backward, alike on every rank."""
    h = embed_tokens(params, cfg, tokens, ax)
    n_prefix = 0
    if prefix_embeds is not None:
        n_prefix = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    S = h.shape[1]
    if positions is None:
        positions = torch.arange(S, device=h.device)[None, :]
    aux: Dict[str, torch.Tensor] = {}
    if _has_moe(cfg):
        aux = {k: torch.zeros((), dtype=torch.float32, device=h.device)
               for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}
    remat = cfg.remat == "full" and h.requires_grad
    for period in _periods(params["blocks"], cfg.n_periods):
        if remat:
            h, aux = checkpoint(_run_period, period, h, aux, cfg, positions, ax,
                                use_reentrant=False)
        else:
            h, aux = _run_period(period, h, aux, cfg, positions, ax)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if n_prefix:
        h = h[:, n_prefix:]
    return h, aux


def forward(
    params,
    cfg,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    ax=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train forward: full-sequence fp32 logits [B, S, V] ([B, S, K, V] for
    codebooks). tokens: [B, S] ([B, K, S]); prefix_embeds: [B, n_prefix, D]
    stub modality embeddings. ``ax``: ``forward_hidden``'s, on a model axis
    that leaves the vocab whole."""
    h, aux = forward_hidden(params, cfg, tokens, prefix_embeds, positions, ax)
    return unembed(params, cfg, h), aux


def loss_fn(params, cfg, batch, ax=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy, plus the router losses of a MoE model.
    batch: dict with "tokens", "labels" (``[B, K, S]`` for codebooks),
    optional "prefix_embeds"; labels use -100 as the ignore index. Every op
    is out of place, so autograd gives the reference's ``jax.grad``
    (``tests/test_torch_train.py``). On a model axis ``ax`` ``params`` are
    this rank's compute blocks (``forward_hidden``), and where ``ax`` splits
    the vocab the logits and cross-entropy are ``parallel.vocab_parallel_nll``:
    no rank holds the whole ``[B, S, V]`` logits."""
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    vocab_split = ax is not None and ax.vocab
    if vocab_split:
        h, aux = forward_hidden(params, cfg, tokens, prefix_embeds=prefix, ax=ax)
    else:
        logits, aux = forward(params, cfg, tokens, prefix_embeds=prefix, ax=ax)
    labels = batch["labels"]
    if cfg.n_codebooks:
        labels = labels.movedim(1, 2)  # [B, K, S] -> [B, S, K], as the logits
    valid = labels != -100
    labels_c = torch.clamp(labels, min=0)
    if vocab_split:
        form = _head_form(cfg)
        w = params["embed"] if form == "tied" else params["lm_head"]
        nll = parallel.vocab_parallel_nll(ax, h, w, labels_c, form, cfg.logit_softcap)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels_c[..., None].long())[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    if aux:
        loss = (loss + cfg.router_aux_coef * aux["moe_lb_loss"]
                + cfg.router_z_coef * aux["moe_z_loss"])
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
    """Stacked decode cache: one entry per pattern index (a KV cache for an
    attention layer, an SSM state for an SSM layer), leading period axis."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    L = cache_length(cfg, seq_len)
    cache: Dict[str, Any] = {}
    for i, (mixer, _) in enumerate(cfg.pattern_):
        if mixer == "attn":
            one = attn_mod.init_kv_cache(batch, max(L, 1), cfg, dtype, dev)
        else:
            one = ssm_mod.init_ssm_cache(batch, cfg, dtype, dev)
        cache[str(i)] = tree_map(
            lambda x: x[None].repeat((cfg.n_periods,) + (1,) * x.dim()), one)
    return cache


def cache_shape(cfg, batch: int, seq_len: int) -> Dict[str, Any]:
    """The ``TensorSpec`` tree of ``init_cache(cfg, batch, seq_len)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return tree_specs(init_cache(cfg, batch, seq_len, device="cpu"))


def decode_step(params, cfg, cache, token, position: int,
                attend=None, ax=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode. token: [B] int ([B, K] for codebooks); position:
    int. Returns (logits [B, V] or [B, K, V], new cache); the cache passed
    in is left as it was. A MoE layer routes the B decode tokens together
    and its aux is discarded. ``attend(i, p, x, cache, position)`` takes
    the place of ``attention.decode_attention`` for pattern index ``i``
    (the cache sharded over ranks: ``distributed/steps.py``). On a model
    axis ``ax`` ``params`` are this rank's compute blocks: the embedding,
    the attention layers ``ax`` splits (through ``attend`` where given),
    the MLPs, the MoE layers' experts, the SSM layers' heads (``cache``
    then holds their blocks of the SSM state and conv ring) and the head
    run on them, and the logits of all V come back on every rank of the
    model group."""
    h = embed_tokens(params, cfg, token, ax)[:, None, :]
    attn_ax = ax if ax is not None and ax.attn else None
    ssm_ax = ax if ax is not None and ax.ssm else None
    new_cache = []
    for p in range(cfg.n_periods):
        lp_p, cache_p = _period(params["blocks"], p), _period(cache, p)
        nc = {}
        for i, (mixer, ff) in enumerate(cfg.pattern_):
            lp = lp_p[str(i)]
            x = rmsnorm(lp["norm1"], h, cfg.norm_eps)
            if mixer == "attn" and attend is not None:
                out, nc[str(i)] = attend(i, lp["mixer"], x, cache_p[str(i)], position)
            elif mixer == "attn":
                out, nc[str(i)] = attn_mod.decode_attention(lp["mixer"], x, cache_p[str(i)],
                                                            cfg, position, ax=attn_ax)
            else:
                out, nc[str(i)] = ssm_mod.decode_ssm(lp["mixer"], x, cache_p[str(i)], cfg,
                                                     ax=ssm_ax)
            h, _ = _feed_forward(lp, h + out, ff, cfg, ax)
        new_cache.append(nc)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params, cfg, h, ax)  # [B, 1, ...]
    return logits[:, 0], tree_map(lambda *xs: torch.stack(xs), *new_cache)
