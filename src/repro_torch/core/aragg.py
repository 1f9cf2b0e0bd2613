"""(delta_max, c)-Agnostic Robust Aggregator (Definition A + Theorem I).

Port of ``repro/core/aragg.py``. ``RobustAggregator`` composes a ``Mixer``
(bucketing / resampling) with a base ``Aggregator``; Theorem I sets
``s = delta_max / delta``.

Randomness: where the reference takes a ``jax.random`` key, the port takes
the drawn mixing matrix ``mix`` (``[m, n]``, from ``mixing_matrix`` and a
``torch.Generator``); without it the mixer's identity-permutation matrix
is used (the reference's ``key=None``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.aggregators import Aggregator, get_aggregator
from repro_torch.core.mixing import Mixer, NoMix, get_mixer
from repro_torch.telemetry import probes

#: Theorem-I breakdown points per base rule.
DELTA_MAX = {
    "krum": 0.25,
    "rfa": 0.5,
    "gm": 0.5,
    "cm": 0.5,
    "median": 0.5,
    "tm": 0.5,
    "trimmed_mean": 0.5,
    "cclip": 0.1,
    "mean": 0.0,
    "avg": 0.0,
}


def theorem1_s(delta: float, delta_max: float, n: int) -> int:
    """``s = delta_max / delta`` capped so mixed inputs keep a good majority."""
    if delta <= 0:
        return 1
    s = int(math.floor(delta_max / delta))
    return max(1, min(s, n))


class RobustAggregator:
    """Mixer o Aggregator composition with the Theorem-I contract."""

    def __init__(self, base: Aggregator, mixer: Optional[Mixer] = None):
        self.base = base
        self.mixer = mixer if mixer is not None else NoMix()

    @classmethod
    def from_spec(
        cls,
        agg: str,
        mixing: str = "bucketing",
        s: Optional[int] = None,
        delta: Optional[float] = None,
        n_workers: Optional[int] = None,
        **agg_kwargs,
    ) -> "RobustAggregator":
        """Build from string spec. If ``s`` is None it is derived from
        Theorem I as ``floor(delta_max / delta)`` (2 without ``delta``)."""
        base = get_aggregator(agg, **agg_kwargs)
        if s is None:
            if delta is None:
                s = 2  # the paper's recommended mild default
            else:
                s = theorem1_s(delta, DELTA_MAX.get(agg.lower(), 0.25), n_workers or 2**30)
        return cls(base, get_mixer(mixing, s=s))

    def mixing_matrix(self, n: int, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
        """The round's ``[m, n]`` mixing matrix, its permutation drawn from
        ``generator`` (identity permutation without one)."""
        return self.mixer.matrix(n, perm=self.mixer.draw_perm(n, generator),
                                 device=device)

    def _mix_for(self, n: int, mix, device) -> torch.Tensor:
        if mix is None:
            return self.mixer.matrix(n, device=device)
        return mix.to(device=device, dtype=torch.float32)

    def __call__(self, xs: torch.Tensor, mix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Aggregate stacked worker vectors ``[n, d] -> [d]``."""
        m = self._mix_for(xs.shape[0], mix, xs.device)
        return self.base.aggregate(self.mixer.apply(m, xs))

    def aggregate_with_stats(self, xs: torch.Tensor, mix: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Dict]:
        """``__call__`` plus the base rule's telemetry stats dict. Stats are
        keyed per *mixed row* (post-bucketing); with ``mixing="none"`` they
        attribute directly to workers."""
        m = self._mix_for(xs.shape[0], mix, xs.device)
        return self.base.aggregate_and_stats(self.mixer.apply(m, xs))

    def _bucket_gram(self, gram: torch.Tensor, mix) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mixing matrix and the mixed Gram ``M G M^T``."""
        if self.base.coordinatewise:
            raise ValueError("coordinatewise base rules do not use Gram weights")
        m = self._mix_for(gram.shape[0], mix, gram.device)
        gram_y = m @ gram.float() @ m.T
        # The product rounds (i, j) and (j, i) apart; its upper triangle,
        # mirrored, keeps the exact ties of the rules' scores (two buckets
        # that are each other's nearest neighbour have the same Krum score),
        # so the lower index wins them whichever path made the Gram.
        return m, torch.triu(gram_y) + torch.triu(gram_y, 1).T

    def worker_weights_from_gram(self, gram: torch.Tensor,
                                 mix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Exact per-worker combination weights ``[n]`` for non-coordinatewise
        base rules: ``w = M^T coeffs(M G M^T)``."""
        m, gram_y = self._bucket_gram(gram, mix)
        return m.T @ self.base.coeffs(gram_y)

    def worker_weights_and_stats_from_gram(self, gram: torch.Tensor,
                                           mix: Optional[torch.Tensor] = None
                                           ) -> Tuple[torch.Tensor, Dict]:
        """``worker_weights_from_gram`` (the same weights, bit for bit) plus
        the base rule's stats, the per-bucket dispersion from the mixed Gram
        and the final per-worker weights ``M^T c``."""
        m, gram_y = self._bucket_gram(gram, mix)
        c, stats = self.base.coeffs_and_stats(gram_y)
        w = m.T @ c
        stats["bucket_dispersion"] = probes.bucket_dispersion_from_gram(gram_y)
        stats["worker_weights"] = w
        return w, stats

    def __repr__(self) -> str:  # pragma: no cover
        return f"RobustAggregator({self.base!r}, {self.mixer!r})"
