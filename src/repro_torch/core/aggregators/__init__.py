"""Robust aggregation rules (the defenses studied by the paper)."""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.aggregators.base import Aggregator, Mean, pairwise_sq_dists_from_gram
from repro_torch.core.aggregators.cclip import AdaptiveCenteredClip, CenteredClip
from repro_torch.core.aggregators.krum import Krum
from repro_torch.core.aggregators.median import CoordinateWiseMedian, TrimmedMean
from repro_torch.core.aggregators.rfa import RFA

_REGISTRY: Dict[str, Any] = {
    "mean": Mean,
    "avg": Mean,
    "krum": Krum,
    "cm": CoordinateWiseMedian,
    "median": CoordinateWiseMedian,
    "rfa": RFA,
    "gm": RFA,
    "cclip": CenteredClip,
    "acclip": AdaptiveCenteredClip,
    "tm": TrimmedMean,
    "trimmed_mean": TrimmedMean,
}


def get_aggregator(name: str, **kwargs) -> Aggregator:
    """Build an aggregator by registry name (case-insensitive)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(set(_REGISTRY))}")
    return _REGISTRY[key](**kwargs)


__all__ = [
    "Aggregator",
    "Mean",
    "Krum",
    "CoordinateWiseMedian",
    "TrimmedMean",
    "RFA",
    "CenteredClip",
    "AdaptiveCenteredClip",
    "get_aggregator",
    "pairwise_sq_dists_from_gram",
]
