"""Host-side structured run logs: JSONL events + ring-buffered step timing
(port of ``repro/telemetry/events.py``).

One event per line, every line a JSON object with at least:

  {"kind": <str>, "t": <float unix seconds>, ...payload}

Kinds and their payloads (validated by ``validate_event``):

  run_meta   {"run_id", "meta": {...}}            — once, first line
  round      {"round": int, "metrics": {...}}     — per training round;
             metric names must be registered in the catalogue
  bench_row  {"bench", "cell": {...}, "stats": {"mean_us", ...}}
  probe      {"name", "data": {...}}              — scripts/coll_probe.py rows
  serve      {"metrics": {...}}                   — serving engine snapshots

The same writer backs the simulators' and the serving engine's logs, so
every producer shares one schema, and ``validate_jsonl`` reads a log back
against it.
"""

from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, Dict, IO, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.telemetry import registry

EVENT_KINDS = ("run_meta", "round", "bench_row", "probe", "serve")

_REQUIRED: Dict[str, tuple] = {
    "run_meta": ("run_id", "meta"),
    "round": ("round", "metrics"),
    "bench_row": ("bench", "cell", "stats"),
    "probe": ("name", "data"),
    "serve": ("metrics",),
}


def _jsonable(x: Any) -> Any:
    """Coerce numpy scalars and arrays and torch tensors (on any device)
    into plain JSON values."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # fp16 / bf16 have no numpy dtype; widening to fp64 is exact
        x = (x.double() if x.is_floating_point() else x).numpy()
    if isinstance(x, Mapping):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, (np.bool_, np.integer)):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    arr = np.asarray(x)
    if arr.ndim == 0:
        return _jsonable(arr.item())
    return [_jsonable(v) for v in arr.tolist()]


class EventLog:
    """Append-only JSONL event writer.

    ``path=None`` keeps events in memory only (``.events``) — handy in tests
    and for producers that want the rows without touching disk."""

    def __init__(self, path: Optional[Union[str, os.PathLike]] = None,
                 run_id: Optional[str] = None):
        self.path = os.fspath(path) if path is not None else None
        self.run_id = run_id
        self.events: List[Dict[str, Any]] = []
        self._fh: Optional[IO[str]] = None
        if self.path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- emission ----------------------------------------------------------
    def emit(self, kind: str, **payload: Any) -> Dict[str, Any]:
        event = {"kind": kind, "t": time.time()}
        event.update(_jsonable(payload))
        validate_event(event)
        self.events.append(event)
        if self._fh is not None:
            self._fh.write(json.dumps(event) + "\n")
            self._fh.flush()
        return event

    def run_meta(self, **meta: Any) -> Dict[str, Any]:
        return self.emit("run_meta", run_id=self.run_id or "run", meta=meta)

    def round(self, round_idx: int, metrics: Mapping[str, Any]) -> Dict[str, Any]:
        return self.emit("round", round=int(round_idx), metrics=metrics)

    def bench_row(self, bench: str, cell: Mapping[str, Any],
                  stats: Mapping[str, Any]) -> Dict[str, Any]:
        return self.emit("bench_row", bench=bench, cell=cell, stats=stats)

    def probe(self, name: str, data: Mapping[str, Any]) -> Dict[str, Any]:
        return self.emit("probe", name=name, data=data)

    def serve(self, metrics: Mapping[str, Any]) -> Dict[str, Any]:
        return self.emit("serve", metrics=metrics)


# -- validation ------------------------------------------------------------
def validate_event(event: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` if ``event`` does not satisfy the schema."""
    if not isinstance(event, Mapping):
        raise ValueError(f"event must be an object, got {type(event).__name__}")
    kind = event.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {kind!r} (expected {EVENT_KINDS})")
    t = event.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or not math.isfinite(t):
        raise ValueError(f"event 't' must be a finite number, got {t!r}")
    missing = [k for k in _REQUIRED[kind] if k not in event]
    if missing:
        raise ValueError(f"{kind} event missing fields {missing}")
    if kind == "round":
        if not isinstance(event["round"], int) or isinstance(event["round"], bool):
            raise ValueError(f"round must be an int, got {event['round']!r}")
        metrics = event["metrics"]
        if not isinstance(metrics, Mapping):
            raise ValueError("round 'metrics' must be an object")
        for name in metrics:
            if not registry.is_registered(name):
                raise ValueError(
                    f"round metric {name!r} is not in the telemetry catalogue")
    if kind == "serve":
        metrics = event["metrics"]
        if not isinstance(metrics, Mapping):
            raise ValueError("serve 'metrics' must be an object")
        for name in metrics:
            if not registry.is_registered(name):
                raise ValueError(
                    f"serve metric {name!r} is not in the telemetry catalogue")


def validate_jsonl(path: Union[str, os.PathLike]) -> List[Dict[str, Any]]:
    """Parse + validate every line of a JSONL event file; return the events.

    Raises ``ValueError`` naming the offending line on the first failure."""
    events: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
                validate_event(event)
            except (json.JSONDecodeError, ValueError) as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            events.append(event)
    return events


# -- step timing -----------------------------------------------------------
class RingTimer:
    """Ring-buffered wall-clock step timer (``perf_counter`` based).

    Keeps the last ``capacity`` durations; ``summary()`` reports count /
    mean / percentiles over the window, so a long run's statistics track
    recent behaviour instead of averaging over warmup."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf = collections.deque(maxlen=capacity)
        self._t0: Optional[float] = None
        self.total = 0       # durations ever recorded (not just in window)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("RingTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.record(dt)
        return dt

    def record(self, seconds: float) -> None:
        self._buf.append(float(seconds))
        self.total += 1

    def __enter__(self) -> "RingTimer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __len__(self) -> int:
        return len(self._buf)

    def summary(self) -> Dict[str, float]:
        if not self._buf:
            return {"count": 0}
        arr = np.asarray(self._buf, dtype=np.float64)
        return {
            "count": int(arr.size),
            "total": int(self.total),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
        }
