"""Bit-flipping, IPM and ALIE attacks (port of ``repro/core/attacks/simple.py``).

- **BF**: Byzantine rows send the negation of what they would have sent.
- **IPM** (Xie et al. 2020): Byzantine rows send ``-(eps/|G|) sum_{i in G} x_i``.
- **ALIE** (Baruch et al. 2019): Byzantine rows send ``mu_G - z * sigma_G``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attacks.base import Attack, good_mean, good_std


class BitFlipping(Attack):
    name = "bitflip"

    def __call__(self, xs, byz_mask, state=None):
        return torch.where(byz_mask[:, None], -xs, xs), state


class IPM(Attack):
    name = "ipm"

    def __init__(self, eps: float = 0.1):
        self.eps = float(eps)

    def __call__(self, xs, byz_mask, state=None):
        mal = (-self.eps) * good_mean(xs, byz_mask)
        return torch.where(byz_mask[:, None], mal[None, :].to(xs.dtype), xs), state


def alie_z(n: int, f: int) -> float:
    """z = max z s.t. phi(z) < (n - f - s)/(n - f), s = floor(n/2 + 1) - f."""
    s = math.floor(n / 2 + 1) - f
    p = (n - f - s) / max(n - f, 1)
    p = min(max(p, 1e-6), 1 - 1e-6)
    return math.sqrt(2.0) * _erfinv(2 * p - 1)


def _erfinv(x: float) -> float:
    # Winitzki's approximation, as in the reference
    a = 0.147
    ln1 = math.log(1 - x * x)
    term = 2 / (math.pi * a) + ln1 / 2
    return math.copysign(math.sqrt(math.sqrt(term**2 - ln1 / a) - term), x)


class ALIE(Attack):
    name = "alie"

    def __init__(self, z: float | None = None, n: int | None = None, f: int | None = None):
        if z is None:
            if n is None or f is None:
                raise ValueError("ALIE needs either z or (n, f)")
            z = alie_z(n, f)
        self.z = float(z)

    def __call__(self, xs, byz_mask, state=None):
        mu = good_mean(xs, byz_mask)
        sd = good_std(xs, byz_mask)
        mal = (mu - self.z * sd).to(xs.dtype)
        return torch.where(byz_mask[:, None], mal[None, :], xs), state
