"""Worker momentum (Algorithm 2) and the CCLIP radius rule.

Port of ``repro/core/momentum.py``:

    m_i^t = beta * m_i^{t-1} + (1 - beta) * g_i     ("ema", Algorithm 2)
    m_i^t = beta * m_i^{t-1} + g_i                  ("pytorch", App. A.2.1)
"""

from __future__ import annotations

from typing import Literal

Convention = Literal["ema", "pytorch"]


def momentum_update(m, g, beta: float, convention: Convention = "ema"):
    """One momentum step on a tensor or a dict of tensors."""
    if convention == "ema":
        step = lambda mi, gi: beta * mi + (1.0 - beta) * gi  # noqa: E731
    elif convention == "pytorch":
        step = lambda mi, gi: beta * mi + gi  # noqa: E731
    else:
        raise ValueError(f"unknown momentum convention {convention!r}")
    if isinstance(m, dict):
        return {k: step(m[k], g[k]) for k in m}
    return step(m, g)


def init_worker_momentum(g0):
    """Paper initialization: m^1 = g(x^0) (alpha = 0 at t = 1); the
    counterpart of the reference's ``init_worker_momentum``."""
    return g0


def cclip_radius(beta: float, base_tau: float = 10.0, scaling: str = "linear") -> float:
    """The paper's clipping-radius rule for CCLIP (App. A.2.1).

    linear: tau = base / (1 - beta)   (recommended)
    sqrt:   tau = base / sqrt(1 - beta)
    none:   tau = base
    """
    if scaling == "linear":
        return base_tau / (1.0 - beta) if beta < 1.0 else float("inf")
    if scaling == "sqrt":
        return base_tau / (1.0 - beta) ** 0.5 if beta < 1.0 else float("inf")
    if scaling == "none":
        return base_tau
    raise ValueError(f"unknown scaling {scaling!r}")
