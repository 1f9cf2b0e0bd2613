"""Plain PyTorch versions of the four ported kernels.

Each is the function its CUDA kernel computes, written with PyTorch
operators. The wrappers use them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds every kernel against them on the card. CM and TM
run the same selection program as the kernels, so they agree bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.selection_network import median_select, trimmed_mean_select


def bucket_mix(mix: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Apply the mixing operator: ``[m, W] @ [W, d] -> [m, d]`` fp32."""
    return mix.float() @ xs.float()


def pairwise_gram(xs: torch.Tensor, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Worker Gram matrix ``acc + X X^T``: ``[W, d] -> [W, W]`` fp32."""
    x32 = xs.float()
    gram = x32 @ x32.T
    return gram if acc is None else acc.float() + gram


def cwise_median(xs: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the worker axis: ``[W, d] -> [d]`` fp32."""
    return median_select(xs.float())


def cwise_trimmed_mean(xs: torch.Tensor, n_trim: int) -> torch.Tensor:
    """Mean of the sorted ``[n_trim, W - n_trim)`` band: ``[W, d] -> [d]`` fp32."""
    return trimmed_mean_select(xs.float(), n_trim)
