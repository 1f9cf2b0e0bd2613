"""Attack abstraction (port of ``repro/core/attacks/base.py``).

An attack transforms the stacked matrix of would-be worker updates
``[n, d]`` (rows where ``byz_mask`` is True are under adversary control)
into the matrix actually sent to the server. Attacks may carry state.
"""

from __future__ import annotations

import abc
from typing import Any, Tuple

import torch


class Attack(abc.ABC):
    name: str = "attack"

    def init_state(self, n: int, d: int, device=None) -> Any:
        return None

    @abc.abstractmethod
    def __call__(self, xs: torch.Tensor, byz_mask: torch.Tensor,
                 state: Any = None) -> Tuple[torch.Tensor, Any]:
        """Return (attacked xs, new state)."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class NoAttack(Attack):
    name = "none"

    def __call__(self, xs, byz_mask, state=None):
        return xs, state


def good_mean(xs: torch.Tensor, byz_mask: torch.Tensor) -> torch.Tensor:
    w = (~byz_mask).float()
    return (w @ xs.float()) / torch.clamp(torch.sum(w), min=1.0)


def good_std(xs: torch.Tensor, byz_mask: torch.Tensor) -> torch.Tensor:
    mu = good_mean(xs, byz_mask)
    w = (~byz_mask).float()[:, None]
    var = torch.sum(w * torch.square(xs.float() - mu), dim=0) / torch.clamp(
        torch.sum(w), min=1.0)
    return torch.sqrt(var)
