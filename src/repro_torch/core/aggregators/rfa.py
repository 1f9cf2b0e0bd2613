"""RFA — geometric median via the smoothed Weiszfeld algorithm
(Pillutla et al., 2019).

Port of ``repro/core/aggregators/rfa.py``. Every iterate ``v = sum_i c_i x_i``
lies in the span of the inputs, so the residual norms are bilinear forms of
the Gram matrix and the whole algorithm runs in coefficient space.
"""

from __future__ import annotations

from typing import List, Tuple

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

    def _weiszfeld(self, gram: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The coefficients and each iteration's smoothed residual norms."""
        n = gram.shape[0]
        gram = gram.float()
        c = torch.full((n,), 1.0 / n, dtype=torch.float32, device=gram.device)
        rs = []
        for _ in range(self.n_iters):
            r = torch.sqrt(resid_sq_norms(gram, c) + self.eps**2)
            rs.append(r)
            w = 1.0 / r
            c = w / torch.sum(w)
        return c, rs

    def coeffs(self, gram: torch.Tensor) -> torch.Tensor:
        return self._weiszfeld(gram)[0]

    def coeffs_and_stats(self, gram):
        """``coeffs`` + per-iteration residual norms (the same iterations)."""
        c, rs = self._weiszfeld(gram)
        r_seq = torch.stack(rs)
        stats = {
            "rfa_resid_norms": r_seq,                     # [T, n]
            "rfa_residual": torch.sum(r_seq, dim=1),      # [T] Weiszfeld objective
            "rfa_iters": self.n_iters,
        }
        return c, stats
