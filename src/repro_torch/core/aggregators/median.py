"""Coordinate-wise median (Yin et al., 2018) and coordinate-wise trimmed mean.

Port of ``repro/core/aggregators/median.py``. Both are coordinatewise, hence
exactly leaf-local, and both run on the pruned Batcher selection network
(``kernels/selection_network.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregators.base import Aggregator
from repro_torch.kernels.selection_network import median_select, trimmed_mean_select


class CoordinateWiseMedian(Aggregator):
    name = "cm"
    coordinatewise = True

    def combine_leaf(self, xs_leaf: torch.Tensor) -> torch.Tensor:
        # for even n the midpoint of the two central order statistics
        return median_select(xs_leaf.float()).to(xs_leaf.dtype)


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean (``TM`` with ``b = f`` in the paper's table)."""

    name = "tm"
    coordinatewise = True

    def __init__(self, n_trim: int = 1):
        self.n_trim = int(n_trim)

    def combine_leaf(self, xs_leaf: torch.Tensor) -> torch.Tensor:
        n = xs_leaf.shape[0]
        b = min(self.n_trim, (n - 1) // 2)
        return trimmed_mean_select(xs_leaf.float(), b).to(xs_leaf.dtype)
