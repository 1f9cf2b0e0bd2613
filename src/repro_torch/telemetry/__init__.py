"""Telemetry (port of ``repro/telemetry``): the serving engine's step timer."""

from repro_torch.telemetry.events import RingTimer

__all__ = ["RingTimer"]
