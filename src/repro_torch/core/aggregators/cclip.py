"""Centered clipping (Karimireddy et al., 2021) and its adaptive variant.

Port of ``repro/core/aggregators/cclip.py``:

    CCLIP(x_1..x_n; v, tau) = v + (1/n) sum_i (x_i - v) * min(1, tau / ||x_i - v||)

iterated ``n_iters`` times from ``v0 = mean``. In Gram space every iterate
stays in the span of the inputs:

    v' = (1 - mean_i(lam_i)) v + (1/n) sum_i lam_i x_i.

``AdaptiveCenteredClip`` (ACClip) sets ``tau_t = tau_mult * median_i
||x_i - v_t||`` each iteration, which makes the operator agnostic to the
spread of the good inputs.

Each form's loop returns its iterate with every iteration's clip weights
and radii, which the ``*_and_stats`` forms report (``_cclip_stats``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.core.aggregators.base import Aggregator, resid_sq_norms
from repro_torch.kernels.selection_network import median_select

#: an iterate, each iteration's clip weights and each iteration's radius
_Trace = Tuple[torch.Tensor, List[torch.Tensor], List]


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of a vector, midpoint for even length (``jnp.median``)."""
    return median_select(v[:, None])[0]


def _cclip_stats(lams: List[torch.Tensor], taus: List) -> Dict[str, torch.Tensor]:
    """Common telemetry dict from per-iteration clip weights and radii."""
    lam32 = torch.stack(lams).float()
    tau32 = (torch.stack(taus).float() if isinstance(taus[0], torch.Tensor)  # ACClip's
             else torch.tensor(taus, dtype=torch.float32, device=lam32.device))
    return {
        "cclip_lam": lam32,                                           # [T, n]
        "cclip_clip_frac": torch.mean((lam32 < 1.0).float(), dim=1),  # [T]
        "cclip_tau": tau32,                                           # [T]
    }


class AdaptiveCenteredClip(Aggregator):
    """ACClip: the clipping radius is the median residual norm times
    ``tau_mult`` at every iteration."""

    name = "acclip"

    def __init__(self, tau_mult: float = 1.0, n_iters: int = 5, eps: float = 1e-12):
        self.tau_mult = float(tau_mult)
        self.n_iters = int(n_iters)
        self.eps = float(eps)

    def _vector(self, xs: torch.Tensor) -> _Trace:
        v = torch.mean(xs, dim=0)
        lams, taus = [], []
        for _ in range(self.n_iters):
            diff = xs - v[None, :]
            norms = torch.sqrt(torch.sum(torch.square(diff.float()), dim=1) + self.eps)
            tau = self.tau_mult * _median(norms)
            lam = torch.clamp(tau / norms, max=1.0).to(xs.dtype)
            lams.append(lam)
            taus.append(tau)
            v = v + torch.mean(lam[:, None] * diff, dim=0)
        return v, lams, taus

    def aggregate(self, xs: torch.Tensor) -> torch.Tensor:
        return self._vector(xs)[0]

    def aggregate_and_stats(self, xs):
        v, lams, taus = self._vector(xs)
        return v, _cclip_stats(lams, taus)

    def _gram_space(self, gram: torch.Tensor) -> _Trace:
        n = gram.shape[0]
        gram = gram.float()
        c = torch.full((n,), 1.0 / n, dtype=torch.float32, device=gram.device)
        lams, taus = [], []
        for _ in range(self.n_iters):
            norms = torch.sqrt(resid_sq_norms(gram, c) + self.eps)
            tau = self.tau_mult * _median(norms)
            lam = torch.clamp(tau / norms, max=1.0)
            lams.append(lam)
            taus.append(tau)
            c = c * (1.0 - torch.mean(lam)) + lam / n
        return c, lams, taus

    def coeffs(self, gram: torch.Tensor) -> torch.Tensor:
        return self._gram_space(gram)[0]

    def coeffs_and_stats(self, gram):
        c, lams, taus = self._gram_space(gram)
        return c, _cclip_stats(lams, taus)


class CenteredClip(Aggregator):
    name = "cclip"

    def __init__(self, tau: float = 10.0, n_iters: int = 3, eps: float = 1e-12):
        self.tau = float(tau)
        self.n_iters = int(n_iters)
        self.eps = float(eps)

    def _vector(self, xs: torch.Tensor) -> _Trace:
        v = torch.mean(xs, dim=0)
        lams = []
        for _ in range(self.n_iters):
            diff = xs - v[None, :]
            norms = torch.sqrt(torch.sum(torch.square(diff.float()), dim=1) + self.eps)
            lam = torch.clamp(self.tau / norms, max=1.0).to(xs.dtype)
            lams.append(lam)
            v = v + torch.mean(lam[:, None] * diff, dim=0)
        return v, lams, [self.tau] * self.n_iters

    def aggregate(self, xs: torch.Tensor) -> torch.Tensor:
        return self._vector(xs)[0]

    def aggregate_and_stats(self, xs):
        v, lams, taus = self._vector(xs)
        return v, _cclip_stats(lams, taus)

    def _gram_space(self, gram: torch.Tensor) -> _Trace:
        n = gram.shape[0]
        gram = gram.float()
        c = torch.full((n,), 1.0 / n, dtype=torch.float32, device=gram.device)
        lams = []
        for _ in range(self.n_iters):
            norms = torch.sqrt(resid_sq_norms(gram, c) + self.eps)
            lam = torch.clamp(self.tau / norms, max=1.0)
            lams.append(lam)
            # v' = v + (1/n) sum_i lam_i (x_i - v)
            c = c * (1.0 - torch.mean(lam)) + lam / n
        return c, lams, [self.tau] * self.n_iters

    def coeffs(self, gram: torch.Tensor) -> torch.Tensor:
        return self._gram_space(gram)[0]

    def coeffs_and_stats(self, gram):
        c, lams, taus = self._gram_space(gram)
        return c, _cclip_stats(lams, taus)
