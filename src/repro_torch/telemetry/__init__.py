"""Telemetry engine (port of ``repro/telemetry``): device-resident
robustness metrics, phase markers and structured run logs.

The paper's central claim — bucketing restores robust-aggregator guarantees
under heterogeneity — is observable through quantities the hot paths
compute anyway: clip fractions and radii (CCLIP), Weiszfeld residuals (RFA),
Krum selection scores, trim masks (TM), and per-bucket dispersion.

  registry.py   metric catalogue (the reference's, spec for spec): every
                metric the probes may emit, with phase / shape kind / doc.
  inflight.py   ``InflightMetrics``, the accumulator threaded through the
                hot paths; its values are the tensors the path holds, left
                on their device until a run stacks them (``stack_series``).
  probes.py     the probe math shared by the stacked and packed engines.
  profiling.py  ``phase()`` markers (``torch.profiler.record_function``),
                ``phase_times()`` (their device ms by CUDA events and the
                allocator's peak at each phase's end) and the
                one-call ``trace_capture``.
  events.py     host-side JSONL event log + ring-buffered step timing.

With ``telemetry=False`` (the default everywhere) a path does the tensor
work it did without telemetry: the same results bit for bit and the same
kernel launches (``repro_torch.kernels.LAUNCHES``).
"""

from repro_torch.telemetry.events import EventLog, RingTimer, validate_event, validate_jsonl
from repro_torch.telemetry.inflight import InflightMetrics
from repro_torch.telemetry.profiling import phase, phase_times, trace_capture
from repro_torch.telemetry.registry import MetricSpec, catalogue, get_metric, register

__all__ = [
    "EventLog",
    "InflightMetrics",
    "MetricSpec",
    "RingTimer",
    "catalogue",
    "get_metric",
    "phase",
    "phase_times",
    "register",
    "trace_capture",
    "validate_event",
    "validate_jsonl",
]
