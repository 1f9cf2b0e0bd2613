"""Per-worker minibatch pipeline (port of ``repro/data/pipeline.py``).

Simulation path: datasets are dense tensors ``[n_workers, m, ...]``; each
step takes a per-worker batch of rows. Where the reference draws the
``[W, B]`` row indices from a ``jax.random`` key inside its samplers, the
port draws them with ``draw_batch_idx`` from a ``torch.Generator`` and the
samplers take them, so a test can hand in the reference's draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_batch_idx(generator: Optional[torch.Generator], n_workers: int, m: int,
                   batch_size: int, device=None) -> torch.Tensor:
    """``[n_workers, batch_size]`` row indices, uniform in ``[0, m)`` with
    replacement (the reference's ``jax.random.randint(key, (W, B), 0, m)``),
    drawn on the CPU and moved to ``device``."""
    idx = torch.randint(0, m, (n_workers, batch_size), generator=generator)
    return idx if device is None else idx.to(device)


def _take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[w, idx[w, b]]`` for every worker w: ``[W, n, ...]`` -> ``[W, B, ...]``."""
    rows = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[rows, idx.to(data.device)]


def sample_worker_batches(idx: torch.Tensor, data_x: torch.Tensor,
                          data_y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx: [W, B], data_x: [W, m, ...], data_y: [W, m] -> ([W, B, ...], [W, B])."""
    return _take_rows(data_x, idx), _take_rows(data_y, idx)


def sample_token_batches(idx: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
    """idx: [W, B], seqs: [W, n_seqs, L] -> [W, B, L]."""
    return _take_rows(seqs, idx)
