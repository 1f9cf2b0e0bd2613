"""Phase markers and one-call profiler trace capture (port of
``repro/telemetry/profiling.py``).

``phase("pack")`` wraps a region in ``torch.profiler.record_function``
under the reference's name ``telemetry/pack``: a named span on the host
timeline while a profiler is active, a cheap no-op otherwise. It changes
no computation, which is why the markers are always on, even with
``telemetry=False``.

``phase_times()`` times the phases on the card: inside its block every
phase also records a pair of CUDA events on the current stream and, at its
end, the allocator's peak so far (``torch.cuda.max_memory_allocated``, a
host-side counter: no synchronise). When the block ends (after a
synchronise) the dict it yielded maps each phase name to its summed
milliseconds, and its ``peaks`` map each phase name to the peak read at
the end of its last run. Outside such a block ``phase`` records no event.

``trace_capture`` is the one-call helper: run any callable under
``torch.profiler.profile`` with the device synchronised before the
capture stops, so the timeline holds the device work the call queued, and
write it as a Chrome trace (open with Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_PREFIX = "telemetry"
#: (name, start, end, peak bytes) while a ``phase_times`` block is open
_EVENTS: Optional[List[Tuple[str, Any, Any, int]]] = None


@contextlib.contextmanager
def phase(name: str):
    """Mark a pipeline phase (pack / gram / mix / kernel / unpack / ...)."""
    with record_function(f"{_PREFIX}/{name}"):
        if _EVENTS is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _EVENTS.append((name, start, end, torch.cuda.max_memory_allocated()))


class PhaseTimes(Dict[str, float]):
    """Phase name -> summed device ms; ``peaks``: phase name -> the
    allocator's peak bytes read at the end of the phase's last run."""

    def __init__(self):
        super().__init__()
        self.peaks: Dict[str, int] = {}


@contextlib.contextmanager
def phase_times():
    """Yields a ``PhaseTimes`` that, once the block ends, maps each phase
    run inside it to its summed device milliseconds (CUDA events) and its
    peak bytes (module docstring)."""
    global _EVENTS
    if _EVENTS is not None:
        raise RuntimeError("phase_times blocks do not nest")
    times = PhaseTimes()
    _EVENTS = events = []
    try:
        yield times
        torch.cuda.synchronize()
        for name, start, end, peak in events:
            times[name] = times.get(name, 0.0) + start.elapsed_time(end)
            times.peaks[name] = peak
    finally:
        _EVENTS = None


def trace_capture(logdir: str, fn: Callable[..., Any], *args: Any,
                  **kwargs: Any) -> Any:
    """Run ``fn(*args, **kwargs)`` under a profiler trace of the host and,
    where CUDA is available, the card.

    Synchronises the card before the trace stops so asynchronously queued
    kernels are inside the capture window. Returns ``fn``'s result; the
    trace lands in ``logdir`` as ``trace_<pid>_<ns>.json``."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    return out
