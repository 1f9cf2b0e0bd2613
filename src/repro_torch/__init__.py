"""PyTorch/CUDA port of the Byzantine-robust bucketing system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/X/y.py`` <-> ``repro_torch/X/y.py``) and imports nothing of
it. Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
CUDA C++ kernel for Hopper (``repro_torch/kernels/csrc``), built with
``nvcc`` at first use.

Numerics: the aggregation math is IEEE fp32. PyTorch's float32 matmuls
are IEEE by default; cuDNN's convolutions default to TF32, so the code that
convolves (the CNN's per-worker gradients in both simulators) runs under
``ieee_fp32()``. Importing the package changes no global flag.

Devices: every entry point takes ``device``. It defaults to ``"cuda"`` and
raises when no GPU is present; the port never falls back to the CPU on its
own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def ieee_fp32():
    """Float32 matmuls and cuDNN convolutions in IEEE fp32 (no TF32) inside
    the block, forward and backward alike when the backward runs inside it;
    the caller's settings come back after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
