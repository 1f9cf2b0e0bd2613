"""PyTorch/CUDA port of the Byzantine-robust bucketing system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/X/y.py`` <-> ``repro_torch/X/y.py``) and imports nothing of
it. Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
CUDA C++ kernel for Hopper (``repro_torch/kernels/csrc``), built with
``nvcc`` at first use.

Numerics: the aggregation math is IEEE fp32. TF32 is switched off for
matmuls and cuDNN on import, so a float32 product on the card keeps full
precision.

Devices: every entry point takes ``device``. It defaults to ``"cuda"`` and
raises when no GPU is present; the port never falls back to the CPU on its
own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
