"""Krum and Multi-Krum (Blanchard et al., 2017).

Port of ``repro/core/aggregators/krum.py``: ``Krum`` selects the worker
whose summed squared distance to its ``n - f - 2`` nearest neighbours is
smallest; Multi-Krum averages the ``m`` best-scoring workers.
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregators.base import Aggregator, pairwise_sq_dists_from_gram


class Krum(Aggregator):
    name = "krum"

    def __init__(self, n_byzantine: int = 0, m: int = 1):
        """Args:
        n_byzantine: assumed number of Byzantine inputs ``f``.
        m: number of top-scoring workers to average (``m=1`` = classic Krum).
        """
        self.n_byzantine = int(n_byzantine)
        self.m = int(m)

    def scores(self, gram: torch.Tensor) -> torch.Tensor:
        n = gram.shape[0]
        dists = pairwise_sq_dists_from_gram(gram)
        # self-distance made +inf-like, then the (n - f - 2) closest others
        big = torch.finfo(torch.float32).max
        dists = dists + torch.eye(n, dtype=dists.dtype, device=dists.device) * big
        k = max(1, min(n - 1, n - self.n_byzantine - 2))
        smallest = torch.topk(dists, k, dim=1, largest=False).values
        return torch.sum(smallest, dim=1)

    def _weights(self, s: torch.Tensor) -> torch.Tensor:
        w = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
        if self.m <= 1:
            w[torch.argmin(s)] = 1.0
            return w
        # multi-krum: average of the m best
        w[torch.argsort(s)[: self.m]] = 1.0 / self.m
        return w

    def coeffs(self, gram):
        return self._weights(self.scores(gram))

    def coeffs_and_stats(self, gram):
        s = self.scores(gram)
        stats = {
            "krum_scores": s,
            "krum_selected": torch.argmin(s).to(torch.int32),
        }
        return self._weights(s), stats
