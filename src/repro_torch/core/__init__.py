"""The paper's contribution: mixing (bucketing/resampling) + agnostic robust
aggregation + momentum, plus the attacks it defends against."""

from repro_torch.core.aggregators import (
    AdaptiveCenteredClip,
    Aggregator,
    CenteredClip,
    CoordinateWiseMedian,
    Krum,
    Mean,
    RFA,
    TrimmedMean,
    get_aggregator,
)
from repro_torch.core.aragg import DELTA_MAX, RobustAggregator, theorem1_s
from repro_torch.core.attacks import Attack, get_attack
from repro_torch.core.mixing import (
    Bucketing,
    FixedGrouping,
    Mixer,
    NoMix,
    Resampling,
    get_mixer,
)
from repro_torch.core.momentum import cclip_radius, momentum_update

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
    "RobustAggregator",
    "DELTA_MAX",
    "theorem1_s",
    "Attack",
    "get_attack",
    "Mixer",
    "NoMix",
    "Bucketing",
    "Resampling",
    "FixedGrouping",
    "get_mixer",
    "cclip_radius",
    "momentum_update",
]
