"""Executable versions of the paper's theoretical objects (port of
``repro/core/theory.py``).

- Lemma 1: mixing reduces pairwise variance by ``s`` while expanding the
  Byzantine fraction to ``s * delta`` — measured by ``pairwise_variance``
  before and after mixing.
- Theorem III: the two-instance lower-bound construction
  (``LowerBoundInstance``) showing no algorithm can beat ``Omega(delta zeta^2)``.
- Heterogeneity / variance estimators (zeta^2, rho^2) used by benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


# ----------------------------------------------------------- variance metrics
def pairwise_variance(xs: torch.Tensor) -> torch.Tensor:
    """Empirical ``rho^2 = E_{i != j} ||x_i - x_j||^2`` over stacked vectors."""
    n = xs.shape[0]
    xs = xs.float()
    gram = xs @ xs.T
    d2 = torch.diagonal(gram)[:, None] + torch.diagonal(gram)[None, :] - 2 * gram
    off = torch.sum(d2) - torch.sum(torch.diagonal(d2))
    return off / (n * (n - 1))


def heterogeneity_zeta_sq(grads: torch.Tensor) -> torch.Tensor:
    """``zeta^2 = E_i ||g_i - gbar||^2`` over stacked worker gradients."""
    g = grads.float()
    gbar = torch.mean(g, dim=0, keepdim=True)
    return torch.mean(torch.sum(torch.square(g - gbar), dim=1))


# --------------------------------------------------- Theorem III lower bound
@dataclasses.dataclass
class LowerBoundInstance:
    """The Theorem-III construction: two indistinguishable worker-function
    sets whose true optima differ, forcing error >= delta*zeta^2/(4 mu).

    World 1: all n workers good; delta*n of them have f_i = mu/2 x^2 - zeta
             delta^{-1/2} x, the rest f_i = mu/2 x^2.  Optimum G/mu.
    World 2: the first delta*n workers are Byzantine (sending exactly the
             same functions); good objective is mu/2 x^2. Optimum 0.

    ``x`` may be a float or a tensor.
    """

    n: int = 10
    delta: float = 0.2
    zeta: float = 1.0
    mu: float = 1.0

    @property
    def n_byz(self) -> int:
        return int(self.delta * self.n)

    @property
    def G(self) -> float:
        return self.zeta * self.delta**0.5

    def worker_grad(self, i: int, x):
        """Gradient reported by worker i — IDENTICAL in both worlds."""
        if i < self.n_byz:
            return self.mu * x - self.zeta * self.delta ** (-0.5)
        return self.mu * x

    def optimum(self, world: int) -> float:
        return self.G / self.mu if world == 1 else 0.0

    def objective(self, world: int, x):
        if world == 1:
            return 0.5 * self.mu * x**2 - self.G * x
        return 0.5 * self.mu * x**2

    def suboptimality_floor(self) -> float:
        """The Omega(delta zeta^2 / mu) bound: max over worlds of f - f*."""
        return self.delta * self.zeta**2 / (4.0 * self.mu)

    def best_achievable_max_error(self) -> Tuple[float, float]:
        """The minimax-optimal output x = G/(2 mu) and its worst-case error,
        evaluated in fp32 as the reference does."""
        x = self.G / (2 * self.mu)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        errs = tuple(
            float(self.objective(w, f32(x)) - self.objective(w, f32(self.optimum(w))))
            for w in (1, 2)
        )
        return x, max(errs)


# ------------------------------------------------ overparameterization (Thm IV)
def overparam_bound_ok(c: float, delta: float, B_sq: float) -> bool:
    """Theorem IV requires B^2 < 1/(3 c delta)."""
    if delta == 0:
        return True
    return B_sq < 1.0 / (3.0 * c * delta)
