"""The mimic attack (paper §3.2, App. B); port of ``repro/core/attacks/mimic.py``.

All Byzantine workers copy the update of one good worker ``i_star``, chosen
during a warmup phase to maximise ``|sum_t z^T x_i^t|`` along the direction
``z`` of largest across-worker variance, tracked online with Oja's rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.attacks.base import Attack, good_mean


class MimicState(NamedTuple):
    t: torch.Tensor          # step counter (scalar int32)
    mu: torch.Tensor         # running mean of good updates [d]
    z: torch.Tensor          # Oja top-eigenvector estimate [d]
    score: torch.Tensor      # cumulative |z . x_i| per worker [n]
    i_star: torch.Tensor     # currently mimicked worker (scalar int32)


class Mimic(Attack):
    name = "mimic"

    def __init__(self, warmup_steps: int = 100):
        self.warmup_steps = int(warmup_steps)

    def init_state(self, n: int, d: int, device=None) -> MimicState:
        return MimicState(
            t=torch.zeros((), dtype=torch.int32, device=device),
            mu=torch.zeros((d,), dtype=torch.float32, device=device),
            z=torch.ones((d,), dtype=torch.float32, device=device) / d ** 0.5,
            score=torch.zeros((n,), dtype=torch.float32, device=device),
            i_star=torch.zeros((), dtype=torch.int32, device=device),
        )

    def __call__(self, xs, byz_mask, state: Optional[MimicState] = None):
        if state is None:
            state = self.init_state(xs.shape[0], xs.shape[1], device=xs.device)
        x32 = xs.float()
        good = (~byz_mask).float()
        t = state.t.float()

        # online mean and Oja top-eigenvector update over good updates
        mu = (t * state.mu + good_mean(xs, byz_mask)) / (t + 1.0)
        centered = (x32 - mu[None, :]) * good[:, None]
        cov_z = centered.T @ (centered @ state.z)
        z = (t * state.z + cov_z) / (t + 1.0)
        z = z / torch.clamp(torch.linalg.norm(z), min=1e-12)

        # cumulative projection scores; Byzantine rows excluded
        score = state.score + torch.abs(x32 @ z) * good

        in_warmup = state.t < self.warmup_steps
        i_star = torch.where(in_warmup, torch.argmax(score), state.i_star).to(torch.int32)

        new_state = MimicState(state.t + 1, mu, z, score, i_star)
        mal = xs[i_star.long()]
        return torch.where(byz_mask[:, None], mal[None, :], xs), new_state


class MimicFixed(Attack):
    """Mimic a fixed worker index (the paper's §3.2 intuition example)."""

    name = "mimic_fixed"

    def __init__(self, i_star: int = 0):
        self.i_star = int(i_star)

    def __call__(self, xs, byz_mask, state=None):
        mal = xs[self.i_star]
        return torch.where(byz_mask[:, None], mal[None, :], xs), state
