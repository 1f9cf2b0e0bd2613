"""The reference's kernel API names, and its composed aggregators.

  gram(xs, acc=None)          stats phase for Krum / RFA / CCLIP / ACClip / mean
  cm_aggregate(xs)            coordinate-wise median
  tm_aggregate(xs, n_trim)    coordinate-wise trimmed mean (sorted band)
  mix_apply(M, xs)            bucketing / resampling application, final combine
  norms(xs, c | center=v)     residual sq-norms (Weiszfeld / CCLIP inner loop)
  cclip_iter(xs, v, lam)      one fused CCLIP iteration (combine + next norms)
  rfa_aggregate(xs)           smoothed Weiszfeld, one norms pass per iteration
  cclip_aggregate(xs, tau)    centered clipping, one fused pass per iteration
  cclip_aggregate_unfused     the pre-fusion schedule (norms over a [W+1, d]
                              pseudo-row stack + a combine pass), the
                              fusion's baseline and the one caller of
                              ``cclip_combine``

Each wrapper takes a tensor on the CPU to its plain PyTorch version and a
CUDA tensor to its CUDA kernel, or raises. Everything here runs on one
device; the multi-rank counterparts, each rank running these kernels on its
own column slice with an all-reduce where the math sums over columns, are
in ``repro_torch.distributed.shard_kernels``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bucket_mix import bucket_mix as mix_apply
from repro_torch.kernels.cclip_combine import cclip_combine
from repro_torch.kernels.cclip_fused import cclip_fused_iter as cclip_iter
from repro_torch.kernels.cwise_median import cwise_median as cm_aggregate
from repro_torch.kernels.pairwise_gram import pairwise_gram as gram
from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean as tm_aggregate
from repro_torch.kernels.weiszfeld_norms import residual_norms as norms

__all__ = ["gram", "cm_aggregate", "tm_aggregate", "mix_apply", "norms", "cclip_iter",
           "rfa_aggregate", "cclip_aggregate", "cclip_aggregate_unfused"]


def _uniform(W: int, device) -> torch.Tensor:
    return torch.full((1, W), 1.0 / W, dtype=torch.float32, device=device)


def rfa_aggregate(xs: torch.Tensor, *, n_iters: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """Geometric median of the worker rows by smoothed Weiszfeld: one
    ``norms`` pass (coefficient form) per iteration, then one combine."""
    W = xs.shape[0]
    c = _uniform(W, xs.device)[0]
    for _ in range(n_iters):
        r2 = norms(xs, c)
        w = 1.0 / torch.sqrt(r2 + eps**2)
        c = w / torch.sum(w)
    return mix_apply(c[None, :], xs)[0]


def cclip_aggregate(xs: torch.Tensor, tau: float, *, n_iters: int = 3,
                    eps: float = 1e-12) -> torch.Tensor:
    """Centered clipping with one fused (combine + next norms) pass per
    iteration; only the initial centre costs a norms pass of its own."""
    v = mix_apply(_uniform(xs.shape[0], xs.device), xs)[0]
    r2 = norms(xs, center=v)
    for _ in range(n_iters):
        lam = torch.clamp(tau / torch.sqrt(r2 + eps), max=1.0)
        v, r2 = cclip_iter(xs, v, lam)
    return v


def cclip_aggregate_unfused(xs: torch.Tensor, tau: float, *, n_iters: int = 3,
                            eps: float = 1e-12) -> torch.Tensor:
    """Pre-fusion CCLIP: per iteration a norms pass over the stack with the
    centre appended as a pseudo-row (a full copy of the stack), then a
    combine pass."""
    W = xs.shape[0]
    v = mix_apply(_uniform(W, xs.device), xs)[0]
    pick = (torch.arange(W + 1, device=xs.device) == W).float()  # selects the centre row
    for _ in range(n_iters):
        diffs2 = norms(torch.cat([xs.float(), v[None, :]], dim=0), pick)[:W]
        lam = torch.clamp(tau / torch.sqrt(diffs2 + eps), max=1.0)
        v = cclip_combine(xs, v, lam)
    return v
