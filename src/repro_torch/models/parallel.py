"""Compute along the model axis: Megatron's tensor-parallel layout for the
training forward and backward.

On a mesh whose ``model`` axis has T > 1 ranks the train step runs each
rank of a model group on its compute blocks of the parameters
(``distributed/sharding.py::compute_shardings``), where T divides the
part (``model_split``):

  attention  split over t head blocks, t the largest divisor of T that
             divides H and divides KV or is a multiple of it
             (``head_blocks``; t = T wherever T itself fits). Rank m
             holds block g = m // r, r = T / t: q heads
             ``[g H/t, (g+1) H/t)``, the columns of wq (bq), the rows of
             wo. Its kv heads are ``[g KV/t, ...)``, aligned with its q
             groups, where t divides KV; else (GQA with KV < t, t a
             multiple of KV) wk / wv are whole and rank m takes the one kv
             head its q heads share. The r ranks of a block are its
             replicas: each computes the block, and only replica 0 adds
             its partial to ``project_out``'s sum (``project_heads``).
  MLP        the columns of w_gate / w_up, the rows of w_down.
  vocab      embed rows ``[m V/T, ...)`` and lm_head columns (each
             codebook's the same).
  MoE        experts ``[m E/T, (m+1) E/T)``: the block on the expert dim
             of the stacked w_gate / w_up ``[P, E, D, F]`` and w_down
             ``[P, E, F, D]``, where T divides E (the reference's expert
             axis over ``model``); each shared expert split as the MLP
             where T also divides d_ff_expert, else whole; the fp32
             router ``[P, D, E]`` whole (``models/moe.py``).
  SSM        SSD heads ``[m H/T, (m+1) H/T)``, where T divides H: their
             z, x and dt columns of in_proj and x channels of the conv,
             A_log / D / dt_bias, the gated norm's scale and out_proj's
             rows; B and C (one group) whole (``models/ssm.py``;
             Megatron's layout as the Mamba-2 paper sets it out,
             arXiv:2405.21060 §8).

Attention with t = 1 (no divisor of T above 1 fits its heads), MoE layers
whose experts T does not split, SSM layers whose heads T does not split,
and the norms run whole on every rank of the group, as without a model
axis.

Two operators over the model group carry the residual stream across a
split part (Megatron's f and g): ``copy_in``, the identity whose backward
all-reduces the gradient, before the column-split products, and
``reduce_out``, an all-reduce whose backward is the identity, after the
row-split product (``project_out``). The residual stream, and every
gradient of a part held whole, is so the same on every rank of the group.
Whole k / v are computed from the stream before ``copy_in`` and pass
through a ``copy_in`` of their own, so wk / wv get whole, equal gradients
and the stream's gradient counts them once. A MoE layer's router gates follow the
same pattern: every rank routes all tokens from the stream, and the gates
enter the combine through a ``copy_in`` of their own; so do an SSM
layer's whole B and C, each after its conv and silu. The SSM's gated
RMSNorm normalises over all of d_inner: ``sum_across`` all-reduces the
fp32 sum of squares of the rank's columns (and, in the backward, its
gradient), which differs from one device's sum in the order of the fp32
additions only.

A 16-bit row-split product (``reduce_out(x @ w)``) rounds each rank's
partial to 16 bits and sums the partials in 16 bits, where one device's
product accumulates in fp32 and rounds once. A dense model keeps that. In
a model whose experts are split (``moe``) the extra rounding moves a
router's near-ties, and a token routed otherwise than on one device is far
off it, so there ``project_out`` writes each rank's partial in fp32 from a
16-bit GEMM, all-reduces the fp32 partials and rounds the sum once: one
device's rounding, at twice the all-reduce's bytes.

The embedding lookup gives a zero row for a token outside the rank's
rows; the rows' all-reduce adds exact zeros, so the embedded stream
equals the one-device one bit for bit. ``vocab_parallel_nll`` is the
logits and the cross-entropy in one ``autograd.Function``: the row max
(an all-reduce of the max, exact), then the fp32 sum of exponentials and
the target logit (one all-reduce of both); it saves the rank's fp32
logits ``[N, V/T]`` and recomputes the softmax from them in the backward,
as Megatron's ``_VocabParallelCrossEntropy`` does.

A replica other than 0 of an attention head block computes the block as
replica 0 does, but its attention output enters ``project_out`` as exact
zeros whose gradient is zero (``_Zeroed``), so each head block is counted
once, the replica's weight and stream gradients through the layer are
zeros, and its graph is replica 0's. Every collective of the training forward and backward is an
``all_reduce`` over the model group, entered by every rank of the group in
the same order, so a period recomputed in the backward (``remat="full"``)
replays them alike on every rank.

Serving (a forward without grad: the prefill and the decode step) runs on
the same blocks and adds two all-gathers over the model group, each
entered by every rank in the same order and concatenating the blocks in
rank order: ``gather_vocab``, the logits of this rank's vocab block into
all V as fp32 (each codebook's on the last dim), and ``gather_heads``, a
decode token's head blocks into all heads, replica 0's block of each
head group where t < T (``attention.decode_attention`` attends over a
cache block whose heads or positions need not be the rank's). Under gloo
a CUDA block is staged through host memory (``sharding._gather_along``),
so both stay one token's or one position's size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import _gather_along


def head_blocks(H: int, KV: int, T: int) -> int:
    """t: the largest divisor of T that divides the H q heads and divides
    the KV kv heads or is a multiple of them (1 where none above 1 does,
    or without heads)."""
    if H <= 0 or KV <= 0:
        return 1
    return max(t for t in range(1, T + 1)
               if T % t == 0 and H % t == 0 and (KV % t == 0 or t % KV == 0))


def model_split(cfg, T: int) -> Dict[str, Any]:
    """Which parts of ``cfg`` run split over T model ranks (module
    docstring): ``attn`` (q heads, and kv heads or whole k / v) over ``t``
    head blocks (``head_blocks``), ``kv`` (the kv heads split too),
    ``mlp`` (d_ff), ``vocab``, ``moe`` (the experts), ``moe_shared`` (the
    shared experts' d_ff_expert, beside split experts), ``ssm`` (an SSM
    layer's heads). Decided from the config and T alone."""
    H, KV, E = cfg.n_heads, cfg.n_kv_heads, cfg.n_experts
    t = head_blocks(H, KV, T)
    attn = T > 1 and t > 1
    moe = T > 1 and E > 0 and E % T == 0
    has_ssm = any(mixer == "ssm" for mixer, _ in cfg.pattern_)
    return {"attn": attn, "kv": attn and KV % t == 0,
            "mlp": T > 1 and cfg.d_ff % T == 0, "vocab": T > 1 and cfg.vocab_size % T == 0,
            "moe": moe, "moe_shared": moe and (cfg.d_ff_expert or cfg.d_ff) % T == 0,
            "ssm": T > 1 and has_ssm and cfg.ssm_heads % T == 0, "t": t}


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis a training forward computes along: the model group,
    this rank's coordinate ``index`` on it, its size T, ``model_split``'s
    flags and the attention's head blocks ``t`` (0 reads as T)."""

    group: Any
    index: int
    size: int
    attn: bool
    kv: bool
    mlp: bool
    vocab: bool
    moe: bool
    moe_shared: bool
    ssm: bool = False
    t: int = 0

    @classmethod
    def of(cls, cfg, mesh) -> Optional["ModelAxis"]:
        """The axis of ``mesh`` (a ``launch.mesh.Mesh``) for ``cfg``;
        ``None`` where the model axis has one rank or there is none."""
        T = mesh.shape.get("model", 1)
        if T == 1:
            return None
        return cls(mesh.axis_group("model"), mesh.coords["model"], T, **model_split(cfg, T))

    @property
    def head_groups(self) -> int:
        """t, the attention's head blocks."""
        return self.t or self.size

    @property
    def replicas(self) -> int:
        """r = T / t: the ranks that hold one attention head block."""
        return self.size // self.head_groups

    @property
    def head_block(self) -> int:
        """This rank's attention head block g = index // r."""
        return self.index // self.replicas

    @property
    def replica(self) -> int:
        """This rank's place among its head block's r ranks."""
        return self.index % self.replicas

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: ``x`` as it is; its gradient all-reduced."""
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: ``x`` summed over the group; its gradient as it is."""
        return _ReduceOut.apply(x, self.group)

    def sum_across(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, whose gradient is summed over the
        group too: a sum that feeds every rank's own columns (the SSM's
        gated norm)."""
        return _SumAcross.apply(x, self.group)

    def project_out(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The row-split product ``x @ w`` (``x`` this rank's columns, ``w``
        its rows) summed over the group: ``reduce_out(x @ w)``, but for a
        16-bit product in a model whose experts are split (module
        docstring), where each rank's partial is written in fp32, the fp32
        partials are summed and the sum is rounded once."""
        if not (self.moe and x.dtype in (torch.bfloat16, torch.float16)):
            return self.reduce_out(x @ w)
        return self.reduce_out(_Fp32Partial.apply(x, w)).to(x.dtype)

    def project_heads(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``project_out`` of the attention's head blocks: ``x`` this rank's
        heads' output, ``w`` its rows of wo. A replica other than 0 hands
        in exact zeros whose gradient is zero, so each head block is summed
        once (module docstring)."""
        return self.project_out(_Zeroed.apply(x) if self.replica else x, w)


def gather_vocab(ax: ModelAxis, logits: torch.Tensor) -> torch.Tensor:
    """All V logits on every rank of the group from each rank's vocab
    block on the last dim (``[..., V/T]``: ``[B, S, V/T]``, or ``[B, S, K,
    V/T]`` for codebooks), in rank order, as fp32."""
    return _gather_along(logits.float(), logits.dim() - 1, ax.group)


def gather_heads(ax: ModelAxis, *blocks: torch.Tensor):
    """Each of ``blocks`` (``[..., h / t, dh]``: this rank's head block of a
    decode token's q, k or v) with all its heads, in head-block order: one
    all-gather of the blocks side by side, replica 0's block of each head
    group kept, split back."""
    flat = [b.flatten(-2) for b in blocks]
    widths = [f.shape[-1] for f in flat]
    lead = tuple(flat[0].shape[:-1])
    got = _gather_along(torch.cat(flat, dim=-1), 0, ax.group)  # [T * lead[0], ...]
    got = got.reshape((ax.size,) + lead + (sum(widths),))[::ax.replicas]
    return [part.movedim(0, -2).reshape(lead + (-1, b.shape[-1]))
            for part, b in zip(got.split(widths, dim=-1), blocks)]


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (every rank gets the result)."""
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _Zeroed(torch.autograd.Function):
    """Exact zeros of ``x``'s shape whose gradient to ``x`` is zeros: the
    graph behind ``x`` runs as it would, and adds nothing."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


class _Fp32Partial(torch.autograd.Function):
    """``x @ w`` of 16-bit ``x [..., F]`` and ``w [F, D]`` written in fp32:
    one 16-bit GEMM with fp32 output (``mm``'s ``out_dtype``), or, on a
    backend without it (the CPU), the product of the widened operands,
    each of whose products fp32 holds exactly. Its gradients are one
    device's 16-bit products from the saved 16-bit operands (the fp32
    gradient that reaches it is a 16-bit one widened)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        try:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        except NotImplementedError:
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return g @ w.mT, gw


# ------------------------------------------------------------ vocab parallel
def _vocab_range(ax: ModelAxis, n_local: int):
    return ax.index * n_local, (ax.index + 1) * n_local


def embed_rows(ax: ModelAxis, tables: torch.Tensor, tokens: torch.Tensor,
               codebooks: int) -> torch.Tensor:
    """The embedded stream from this rank's rows of the table(s): a token
    outside them gives a zero row, and the rows are all-reduced (exact).
    ``tables`` is ``[V/T, D]``, or ``[K, V/T, D]`` with ``tokens`` ``[B, K,
    ...]``, whose K rows are all-reduced before they are summed, as one
    device sums the whole tables' rows."""
    v0, v1 = _vocab_range(ax, tables.shape[-2])

    def rows(table, tok):
        hit = (tok >= v0) & (tok < v1)
        r = table[torch.where(hit, tok - v0, 0)]
        return torch.where(hit[..., None], r, 0.0)

    if codebooks:
        return ax.reduce_out(torch.stack([rows(tables[k], tokens[:, k])
                                          for k in range(codebooks)])).sum(0)
    return ax.reduce_out(rows(tables, tokens))


def _local_logits(form: str, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if form == "books":  # h [B, S, D], w [K, D, V/T] -> [B, S, K, V/T]
        return torch.einsum("bsd,kdv->bskv", h, w)
    return h @ (w.T if form == "tied" else w)


class _VocabParallelNLL(torch.autograd.Function):
    """``-log softmax(logits)[label]`` of every position, the logits split
    over the vocab (``vocab_parallel_nll``)."""

    @staticmethod
    def forward(ctx, h, w, labels, ax, form, softcap):
        z = _local_logits(form, h, w).float()
        if softcap > 0:
            z = softcap * torch.tanh(z / softcap)
        v0, v1 = _vocab_range(ax, z.shape[-1])
        m = _all_reduce(torch.amax(z, dim=-1), ax.group, dist.ReduceOp.MAX)
        hit = (labels >= v0) & (labels < v1)
        local = torch.where(hit, labels - v0, 0).long()
        zt = torch.where(hit, torch.gather(z, -1, local[..., None])[..., 0], 0.0)
        sums = _all_reduce(torch.stack([torch.sum((z - m[..., None]).exp_(), dim=-1), zt]),
                           ax.group)
        s, zt = sums[0], sums[1]
        ctx.save_for_backward(h, w, z, m, s, local, hit)
        ctx.ax, ctx.form, ctx.softcap = ax, form, softcap
        return -((zt - m) - torch.log(s))

    @staticmethod
    def backward(ctx, grad):
        h, w, z, m, s, local, hit = ctx.saved_tensors
        ax, form, c = ctx.ax, ctx.form, ctx.softcap
        # d nll / d z = softmax(z) - onehot(label), times the position's grad
        dz = (z - m[..., None]).exp_().div_(s[..., None]).mul_(grad[..., None])
        dz.scatter_add_(-1, local[..., None], -(grad * hit)[..., None].to(dz.dtype))
        if c > 0:  # through c tanh(u / c): 1 - tanh^2, with tanh = z / c
            dz.mul_(z.div_(c).square_().neg_().add_(1.0))
        del z
        du = dz.to(h.dtype)
        del dz
        if form == "books":
            dh = torch.einsum("bskv,kdv->bsd", du, w)
            dw = torch.einsum("bsd,bskv->kdv", h, du)
        elif form == "tied":
            dh = du @ w
            dw = du.reshape(-1, du.shape[-1]).T @ h.reshape(-1, h.shape[-1])
        else:
            dh = du @ w.T
            dw = h.reshape(-1, h.shape[-1]).T @ du.reshape(-1, du.shape[-1])
        return _all_reduce(dh, ax.group), dw, None, None, None, None


def vocab_parallel_nll(ax: ModelAxis, h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       form: str, softcap: float = 0.0) -> torch.Tensor:
    """Each position's cross-entropy from the stream ``h`` ``[B, S, D]`` and
    this rank's vocab block ``w`` of the head: ``form`` ``"head"`` (lm_head
    ``[D, V/T]``, labels ``[B, S]``), ``"tied"`` (embed ``[V/T, D]``) or
    ``"books"`` (lm_head ``[K, D, V/T]``, labels ``[B, S, K]``); labels
    in ``[0, V)``. The same on every rank of the group; the stream's
    gradient is all-reduced in the backward."""
    return _VocabParallelNLL.apply(h, w, labels, ax, form, softcap)
