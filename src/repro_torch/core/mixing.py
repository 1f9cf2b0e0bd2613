"""Gradient mixing — the paper's core contribution (Algorithm 1).

Port of ``repro/core/mixing.py``. Both mixers are linear operators
``y = M x`` with a row-stochastic ``[m, n]`` matrix:

- **Bucketing** (ICLR camera-ready): permute the ``n`` inputs, split into
  ``ceil(n/s)`` buckets, average each bucket.
- **Resampling** (preprint Algorithm 1): replicate each input ``s`` times,
  permute the ``s*n`` copies, average consecutive groups of ``s``.
- ``FixedGrouping`` is bucketing with the identity permutation.

Randomness: ``matrix(n, perm=...)`` takes the drawn permutation, so a test
can pass in the one the reference drew; ``perm=None`` is the identity (the
reference's ``key=None``). ``draw_perm`` draws one from a
``torch.Generator``.
"""

from __future__ import annotations

import abc
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


@functools.lru_cache(maxsize=None)
def _bucketing_base(n: int, s: int) -> np.ndarray:
    """Identity-permutation bucketing matrix ``[ceil(n/s), n]`` (fp32): slot
    ``j`` feeds bucket ``j // s`` with weight ``1/|bucket|``."""
    m = math.ceil(n / s)
    bucket_of = np.arange(n) // s
    sizes = np.bincount(bucket_of, minlength=m).astype(np.float32)
    base = np.zeros((m, n), np.float32)
    base[bucket_of, np.arange(n)] = 1.0
    base /= sizes[:, None]
    return base


@functools.lru_cache(maxsize=None)
def _resampling_src(n: int, s: int) -> np.ndarray:
    """Replica->input map of the ``s*n`` slots (== the slot->group map):
    slot ``k`` holds a replica of input ``k // s``."""
    return np.arange(s * n) // s


def _as_index(perm) -> torch.Tensor:
    """A drawn permutation (tensor, numpy array or sequence) as CPU int64."""
    if isinstance(perm, torch.Tensor):
        return perm.to(device="cpu", dtype=torch.long)
    return torch.from_numpy(np.array(perm, dtype=np.int64))


class Mixer(abc.ABC):
    """Builds the mixing matrix ``M: [m, n]`` for a given round."""

    name: str = "mixer"
    #: mixing factor s (1 = no-op shuffle)
    s: int = 1

    def perm_size(self, n: int) -> int:
        """Length of the permutation ``matrix`` takes (0: it takes none)."""
        return 0

    def draw_perm(self, n: int, generator: Optional[torch.Generator]):
        """A random permutation for ``matrix``, or ``None`` when this mixer
        draws nothing or no generator is given."""
        size = self.perm_size(n)
        if size == 0 or generator is None:
            return None
        return torch.randperm(size, generator=generator)

    @abc.abstractmethod
    def matrix(self, n: int, perm=None, device=None) -> torch.Tensor:
        """The row-stochastic mixing matrix ``[n_out, n]`` (fp32)."""

    def apply(self, mix: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Stacked application of a matrix from ``matrix``."""
        return (mix @ xs.float()).to(xs.dtype)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}(s={self.s})"


class NoMix(Mixer):
    """Identity (vanilla aggregation, the paper's 'without' columns)."""

    name = "none"
    s = 1

    def matrix(self, n, perm=None, device=None):
        return torch.eye(n, dtype=torch.float32, device=resolve_device(device))

    def apply(self, mix, xs):
        return xs


class Bucketing(Mixer):
    """Permute, split into ceil(n/s) buckets, average. If ``s`` does not
    divide ``n`` the last bucket is smaller (still row-stochastic)."""

    name = "bucketing"

    def __init__(self, s: int = 2):
        if s < 1:
            raise ValueError("s must be >= 1")
        self.s = int(s)

    def perm_size(self, n: int) -> int:
        return n

    def matrix(self, n, perm=None, device=None):
        base = torch.tensor(_bucketing_base(n, self.s))  # a copy: the cache stays intact
        if perm is not None:
            # input perm[k] lands in slot k: column perm[k] of M is column k
            # of the identity-permutation matrix
            out = torch.zeros_like(base)
            out[:, _as_index(perm)] = base
            base = out
        return base.to(resolve_device(device))


class FixedGrouping(Bucketing):
    """Bucketing without the per-round random permutation (Chen et al. 2017)."""

    name = "fixed_grouping"

    def perm_size(self, n: int) -> int:
        return 0

    def matrix(self, n, perm=None, device=None):
        return super().matrix(n, None, device)


class Resampling(Mixer):
    """s-fold replication + permutation + group-average: each input feeds
    at most ``s`` of the ``n`` outputs (sampling without replacement)."""

    name = "resampling"

    def __init__(self, s: int = 2):
        if s < 1:
            raise ValueError("s must be >= 1")
        self.s = int(s)

    def perm_size(self, n: int) -> int:
        return self.s * n

    def matrix(self, n, perm=None, device=None):
        s = self.s
        src = torch.from_numpy(_resampling_src(n, s))
        group_of = src
        perm = (torch.arange(s * n) if perm is None
                else _as_index(perm))
        mat = torch.zeros((n, n), dtype=torch.float32)
        # slot t holds replica perm[t] of input src[perm[t]], feeding group_of[t]
        mat.index_put_((group_of, src[perm]),
                       torch.full((s * n,), 1.0 / s, dtype=torch.float32),
                       accumulate=True)
        return mat.to(resolve_device(device))


def get_mixer(name: str, s: int = 2) -> Mixer:
    name = (name or "none").lower()
    if name in ("none", "identity", "no", ""):
        return NoMix()
    if name == "bucketing":
        return Bucketing(s)
    if name == "resampling":
        return Resampling(s)
    if name == "fixed_grouping":
        return FixedGrouping(s)
    raise KeyError(f"unknown mixer {name!r}")
