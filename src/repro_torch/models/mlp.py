"""The paper's MNIST worker models (port of ``repro/models/mlp.py``).

A 784-128-10 ReLU MLP with NLL loss, kept as the reference's dict of
parameters ``{"w0", "b0", "w1", "b1"}`` with ``w`` of shape ``[d_in, d_out]``,
so that a flattened gradient has the reference's layout.

The CNN of App. Table 5 (CONV-CONV-FC-FC; ``scale`` multiplies the widths,
the App. A.2.3 overparameterisation knob) keeps the reference's leaves and
layouts too: ``conv1`` ``[3, 3, 1, 8s]`` and ``conv2`` ``[3, 3, 8s, 16s]``
in HWIO, ``fc1`` ``[16s * 49, 64s]`` whose rows run (h, w, c) as the
reference flattens NHWC, ``b1``, ``fc2`` ``[64s, 10]``, ``b2``. ``cnn_apply``
convolves in PyTorch's NCHW with the weights permuted to OIHW at apply time
and permutes to NHWC before the flatten. cuDNN convolves in TF32 unless
told otherwise, and the caller picks the precision: both simulators take
their per-worker gradients, forward and backward, under ``ieee_fp32()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

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


# ------------------------------------------------------- the CNN (Table 5)
def init_cnn(generator: Optional[torch.Generator] = None, scale: int = 1,
             device=None) -> Dict[str, torch.Tensor]:
    """CONV-CONV-FC-FC with widths ``8s, 16s, 64s``: the convolutions drawn
    normal times 0.1, the FCs normal times ``1/sqrt(fan_in)`` (from
    ``generator`` on the CPU, in the order conv1, conv2, fc1, fc2, then
    moved), zero biases."""
    dev = resolve_device(device)
    c1, c2, f1 = 8 * scale, 16 * scale, 64 * scale
    draw = lambda *shape: torch.randn(shape, generator=generator)  # noqa: E731
    params = {
        "conv1": draw(3, 3, 1, c1) * 0.1,
        "conv2": draw(3, 3, c1, c2) * 0.1,
        "fc1": draw(c2 * 49, f1) * (1.0 / (c2 * 49)) ** 0.5,
        "b1": torch.zeros((f1,)),
        "fc2": draw(f1, 10) * (1.0 / f1) ** 0.5,
        "b2": torch.zeros((10,)),
    }
    return {k: v.to(dev) for k, v in params.items()}


def cnn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [B, 784] (28 x 28, one channel) -> logits [B, 10]. Each conv is a
    3 x 3 "SAME" cross-correlation (padding 1), then ReLU and a 2 x 2 max
    pool of stride 2 (28 -> 14 -> 7; its gradient goes to a window's first
    maximum, as the reference's ``reduce_window`` max does)."""
    B = x.shape[0]
    h = x.reshape(B, 1, 28, 28)
    for name in ("conv1", "conv2"):
        h = F.conv2d(h, params[name].permute(3, 2, 0, 1), padding=1)  # HWIO -> OIHW
        h = F.max_pool2d(torch.relu(h), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(B, -1)  # NHWC order: fc1's rows run (h, w, c)
    h = torch.relu(h @ params["fc1"] + params["b1"])
    return h @ params["fc2"] + params["b2"]


def cnn_nll_loss(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(cnn_apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[:, None]))
