"""Config system (port of ``repro/configs/base.py``).

This slice carries ``ByzConfig``, the paper's technique; ``ModelConfig``
and the mesh and training configs come with the LLM slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ByzConfig:
    """The paper's technique, as a first-class training feature."""

    aggregator: str = "mean"        # mean | krum | cm | rfa | cclip | acclip | tm
    mixing: str = "none"            # none | bucketing | resampling | fixed_grouping
    s: int = 2                      # mixing factor (Alg. 1)
    delta: float = 0.0              # assumed Byzantine fraction
    worker_momentum: float = 0.9    # beta of Alg. 2 (0 = off)
    momentum_convention: str = "ema"
    cclip_tau: float = 10.0         # base clipping radius, scaled per App. A.2.1
    cclip_tau_scaling: str = "linear"
    attack: str = "none"
    attack_kwargs: tuple = ()
    n_byzantine: int = 0

    def make_aggregator(self, n_workers: int):
        from repro_torch.core.aragg import RobustAggregator
        from repro_torch.core.momentum import cclip_radius

        kwargs = {}
        if self.aggregator == "cclip":
            kwargs["tau"] = cclip_radius(
                self.worker_momentum, self.cclip_tau, self.cclip_tau_scaling
            )
        if self.aggregator == "krum":
            kwargs["n_byzantine"] = self.n_byzantine
        if self.aggregator == "tm":
            kwargs["n_trim"] = max(1, self.n_byzantine)
        return RobustAggregator.from_spec(
            self.aggregator,
            mixing=self.mixing,
            s=self.s,
            delta=self.delta,
            n_workers=n_workers,
            **kwargs,
        )
