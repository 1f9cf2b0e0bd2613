"""Byzantine attacks studied by the paper (§3.2, §6.2)."""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.attacks.base import Attack, NoAttack, good_mean, good_std
from repro_torch.core.attacks.mimic import Mimic, MimicFixed, MimicState
from repro_torch.core.attacks.simple import ALIE, IPM, BitFlipping, alie_z

_REGISTRY: Dict[str, Any] = {
    "none": NoAttack,
    "bitflip": BitFlipping,
    "bf": BitFlipping,
    "ipm": IPM,
    "alie": ALIE,
    "mimic": Mimic,
    "mimic_fixed": MimicFixed,
}


def get_attack(name: str, **kwargs) -> Attack:
    key = (name or "none").lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown attack {name!r}; have {sorted(set(_REGISTRY))}")
    return _REGISTRY[key](**kwargs)


__all__ = [
    "Attack",
    "NoAttack",
    "BitFlipping",
    "IPM",
    "ALIE",
    "Mimic",
    "MimicFixed",
    "MimicState",
    "alie_z",
    "get_attack",
    "good_mean",
    "good_std",
]
