"""RFA — geometric median via the smoothed Weiszfeld algorithm
(Pillutla et al., 2019).

Port of ``repro/core/aggregators/rfa.py``. Every iterate ``v = sum_i c_i x_i``
lies in the span of the inputs, so the residual norms are bilinear forms of
the Gram matrix and the whole algorithm runs in coefficient space.
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregators.base import Aggregator, resid_sq_norms


class RFA(Aggregator):
    name = "rfa"

    def __init__(self, n_iters: int = 8, eps: float = 1e-6):
        """Args:
        n_iters: Weiszfeld iterations ``T`` (paper default T=8).
        eps: smoothing constant nu of the smoothed Weiszfeld algorithm.
        """
        self.n_iters = int(n_iters)
        self.eps = float(eps)

    def coeffs(self, gram: torch.Tensor) -> torch.Tensor:
        n = gram.shape[0]
        gram = gram.float()
        c = torch.full((n,), 1.0 / n, dtype=torch.float32, device=gram.device)
        for _ in range(self.n_iters):
            r = torch.sqrt(resid_sq_norms(gram, c) + self.eps**2)
            w = 1.0 / r
            c = w / torch.sum(w)
        return c
