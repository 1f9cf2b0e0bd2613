"""Learning-rate schedules (port of ``repro/optim/schedule.py``): plain
callables from a step to an fp32 scalar tensor."""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant_lr(lr: float) -> Callable:
    return lambda step: _f32(lr)


def cosine_lr(lr: float, total_steps: int, min_frac: float = 0.1) -> Callable:
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))

    return f


def warmup_cosine_lr(lr: float, total_steps: int, warmup_steps: int = 100,
                     min_frac: float = 0.1) -> Callable:
    cos = cosine_lr(lr, max(total_steps - warmup_steps, 1), min_frac)

    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return f
