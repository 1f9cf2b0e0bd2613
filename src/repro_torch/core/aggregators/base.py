"""Robust aggregator abstraction (port of ``repro/core/aggregators/base.py``).

Every aggregator supports two equivalent forms:

1. **Stacked form** — ``aggregate(xs)`` with ``xs: [n, d]`` returning ``[d]``.
2. **Factorized (Gram-space) form** — either ``coordinatewise = True`` (CM,
   trimmed mean: exact leaf by leaf via ``combine_leaf``), or
   ``coeffs(gram)`` mapping the ``[n, n]`` fp32 Gram matrix to weights
   ``w: [n]`` with aggregate ``sum_i w_i x_i`` (Krum: one-hot; RFA:
   Weiszfeld in coefficient space; CCLIP: clipping in coefficient space;
   mean: uniform). Mixing composes as ``G_mixed = M G M^T`` with final
   worker weights ``M^T w``.

The ``*_and_stats`` forms add the telemetry stats dict
(``repro_torch/telemetry``). They run the tensor operations of the plain
forms, so their aggregate equals the plain one bit for bit, except where
the plain form takes a shortcut of its own (``Mean.aggregate``).
"""

from __future__ import annotations

import abc
from typing import Dict, Tuple

import torch

from repro_torch.telemetry import probes


def pairwise_sq_dists_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """``D[i,j] = ||x_i - x_j||^2`` from the Gram matrix."""
    diag = torch.diagonal(gram)
    return diag[:, None] + diag[None, :] - 2.0 * gram


def resid_sq_norms(gram: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``||v - x_i||^2`` for ``v = sum_j c_j x_j``, from the Gram matrix:
    ``c^T G c - 2 (G c)_i + G_ii``, clamped at 0."""
    gc = gram @ c
    quad = c @ gc
    return torch.clamp(quad - 2.0 * gc + torch.diagonal(gram), min=0.0)


class Aggregator(abc.ABC):
    """Base class. Subclasses set ``name`` and implement one of the forms."""

    name: str = "base"
    #: True => exact leaf-local aggregation via combine_leaf (CM, TM).
    coordinatewise: bool = False

    def aggregate(self, xs: torch.Tensor) -> torch.Tensor:
        """Aggregate stacked worker vectors ``xs: [n, d] -> [d]``."""
        if self.coordinatewise:
            return self.combine_leaf(xs)
        x32 = xs.float()
        w = self.coeffs(x32 @ x32.T)
        return (w.to(xs.dtype) @ xs)

    def aggregate_and_stats(self, xs: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """``aggregate`` plus the telemetry stats dict (telemetry-on paths
        only)."""
        if self.coordinatewise:
            out = self.combine_leaf(xs)
            return out, probes.coordinatewise_stats(self, xs, out)
        x32 = xs.float()
        gram = x32 @ x32.T
        w, stats = self.coeffs_and_stats(gram)
        stats["bucket_dispersion"] = probes.bucket_dispersion_from_gram(gram)
        return w.to(xs.dtype) @ xs, stats

    def coeffs(self, gram: torch.Tensor) -> torch.Tensor:
        """Combination coefficients ``[n]`` from the Gram matrix ``[n, n]``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the Gram-space form")

    def coeffs_and_stats(self, gram: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """``coeffs`` plus the telemetry stats dict. Default: no stats."""
        return self.coeffs(gram), {}

    def combine_leaf(self, xs_leaf: torch.Tensor) -> torch.Tensor:
        """Exact leaf-local aggregation ``[n, ...] -> [...]`` (coordinatewise only)."""
        raise NotImplementedError(f"{type(self).__name__} is not coordinatewise")

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class Mean(Aggregator):
    """Plain averaging — the non-robust baseline (``Avg`` in the paper)."""

    name = "mean"

    def coeffs(self, gram):
        n = gram.shape[0]
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=gram.device)

    def aggregate(self, xs):
        return torch.mean(xs, dim=0)
