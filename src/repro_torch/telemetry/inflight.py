"""``InflightMetrics`` — the accumulator threaded through the hot paths (port
of ``repro/telemetry/inflight.py``).

The recorded values are the tensors the path already holds (or small
reductions of them), left on their device; the dict it hands back
(``tree()``) rides out of the call beside the result. Nothing here
synchronises with the device or runs a collective.

Zero work when off: a disabled accumulator records nothing AND never
evaluates lazily-provided values, so guarding a probe as

    tm.put("cclip_clip_frac", lambda: torch.mean((lam < 1.0).float(), dim=1))

adds no tensor operation to the telemetry-off path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Union

import numpy as np
import torch

from repro_torch.telemetry import registry

Value = Union[Any, Callable[[], Any]]


class InflightMetrics:
    """Device-resident metrics accumulated along one call."""

    __slots__ = ("enabled", "_vals")

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._vals: Dict[str, Any] = {}

    def __bool__(self) -> bool:
        return self.enabled

    def put(self, name: str, value: Value) -> None:
        """Record one metric. ``value`` may be a zero-arg callable that is
        ONLY invoked when telemetry is enabled (the zero-work guard)."""
        if not self.enabled:
            return
        registry.get_metric(name)  # refuse names missing from the catalogue
        self._vals[name] = value() if callable(value) else value

    def update(self, stats: Union[Mapping[str, Any], None]) -> None:
        """Merge a probe's stats dict (e.g. an aggregator's)."""
        if not self.enabled or not stats:
            return
        for k, v in stats.items():
            self.put(k, v)

    def tree(self) -> Dict[str, Any]:
        """The metrics dict (empty when off)."""
        return dict(self._vals)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        state = "on" if self.enabled else "off"
        return f"InflightMetrics({state}, {sorted(self._vals)})"


def stack_series(per_step: Mapping[str, List[Any]]) -> Dict[str, np.ndarray]:
    """Each metric's per-step values stacked into one numpy array with a
    leading step axis: the sims' ``history["telemetry"]``. Tensors are
    stacked on their device and copied to the host once per metric, at the
    end of a run."""
    out = {}
    for name, vs in per_step.items():
        if all(isinstance(v, torch.Tensor) for v in vs):
            out[name] = torch.stack([v.detach() for v in vs]).cpu().numpy()
        else:
            out[name] = np.stack([np.asarray(v) for v in vs])
    return out
