"""Probe math shared by the stacked and packed aggregation paths (port of
``repro/telemetry/probes.py``).

These functions compute *diagnostic* quantities from intermediates the hot
path already holds (the mixed rows, the kernels' outputs, the Gram
matrix). They run only when telemetry is ON, as plain PyTorch: they launch
no kernel of ``repro_torch.kernels``. Each reduces over the columns by a
sum, so over a group of ranks each rank probes its column slice and the
packed engine all-reduces the results (``packing.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def bucket_dispersion(mixed: torch.Tensor, n_eff: Optional[int] = None) -> torch.Tensor:
    """``||y_i - mean_j y_j||^2`` per mixed row, from the stacked buffer.

    ``n_eff`` divides nothing here (squared distances are sums, not means)
    but is accepted for signature symmetry with the other probes."""
    del n_eff
    x = mixed.float()
    centered = x - torch.mean(x, dim=0, keepdim=True)
    return torch.sum(torch.square(centered), dim=1)


def bucket_dispersion_from_gram(gram_y: torch.Tensor) -> torch.Tensor:
    """Same quantity from the mixed Gram matrix (the factorized path):
    ``||y_i - ybar||^2 = G_ii - 2 mean_j G_ij + mean_jk G_jk``."""
    g = gram_y.float()
    row_mean = torch.mean(g, dim=1)
    return torch.diagonal(g) - 2.0 * row_mean + torch.mean(row_mean)


def cm_worker_dev(mixed: torch.Tensor, median: torch.Tensor,
                  n_eff: Optional[int] = None) -> torch.Tensor:
    """Mean |y_i - median| per input row.

    The ALIE signature: honest rows deviate ~0.8 sigma per coordinate from
    the median while ALIE rows sit at |z| sigma (z ~= 0.25-0.4) — Byzantine
    rows are suspiciously CLOSE to the median. ``n_eff`` corrects the mean
    for zero-padded packed-buffer columns (pad columns contribute 0 to the
    sum but would dilute a plain mean)."""
    x = mixed.float()
    dev = torch.sum(torch.abs(x - median[None, :].float()), dim=1)
    return dev / float(n_eff if n_eff else mixed.shape[1])


def tm_trim_frac(mixed: torch.Tensor, n_trim: int,
                 n_eff: Optional[int] = None) -> torch.Tensor:
    """Fraction of coordinates where row i fell inside a trimmed band — the
    compressed trim mask. A row is trimmed at a coordinate when its value is
    strictly below the b-th smallest kept value or strictly above the b-th
    largest kept value (ties with the band edge count as kept, matching the
    mean-of-the-sorted-band semantics of ``trimmed_mean_select``)."""
    x = mixed.float()
    W = x.shape[0]
    b = min(int(n_trim), (W - 1) // 2)
    if b == 0:
        return torch.zeros((W,), dtype=torch.float32, device=x.device)
    srt = torch.sort(x, dim=0).values
    lo, hi = srt[b], srt[W - 1 - b]
    mask = (x < lo[None, :]) | (x > hi[None, :])
    frac = torch.sum(mask.float(), dim=1)
    return frac / float(n_eff if n_eff else mixed.shape[1])


def coordinatewise_stats(base, mixed: torch.Tensor, out: torch.Tensor,
                         n_eff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stats for a coordinatewise rule given the mixed stack and aggregate.

    ``base`` is the aggregator (``cm`` / ``tm`` get rule-specific masks;
    every rule gets per-bucket dispersion)."""
    stats = {"bucket_dispersion": bucket_dispersion(mixed)}
    if base.name == "cm":
        stats["cm_worker_dev"] = cm_worker_dev(mixed, out, n_eff)
    elif base.name == "tm":
        stats["tm_trim_frac"] = tm_trim_frac(mixed, base.n_trim, n_eff)
    return stats
