"""The paper's MNIST worker model (port of ``repro/models/mlp.py``).

A 784-128-10 ReLU MLP with NLL loss, kept as the reference's dict of
parameters ``{"w0", "b0", "w1", "b1"}`` with ``w`` of shape ``[d_in, d_out]``,
so that a flattened gradient has the reference's layout. The CNN of App.
Table 5 comes in a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device


def init_mlp(generator: Optional[torch.Generator] = None,
             sizes: Sequence[int] = (784, 128, 10), device=None) -> Dict[str, torch.Tensor]:
    """He-normal weights drawn from ``generator`` (on the CPU, then moved),
    zero biases."""
    dev = resolve_device(device)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((d_in, d_out), generator=generator) * (2.0 / d_in) ** 0.5
        params[f"w{i}"] = w.to(dev)
        params[f"b{i}"] = torch.zeros((d_out,), device=dev)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [B, 784] -> logits [B, 10]."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def nll_loss(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[:, None]))


def accuracy(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(mlp_apply(params, x), dim=-1) == y).float())
