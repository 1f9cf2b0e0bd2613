"""Metric registry — the catalogue of everything the probes may emit (port of
``repro/telemetry/registry.py``: the same names, phases, kinds and docs).

A metric is registered once, at import time, with its phase (which part of
the pipeline produces it), shape kind, and a one-line doc. ``InflightMetrics``
refuses to record unregistered names, so the catalogue cannot silently
drift from the code, and the JSONL schema validator
(``events.validate_event``) can check that a ``round`` event only carries
known metrics.

Shape kinds (the trailing axes; a host-side series stacks rounds in front):

  scalar       ``[]``
  per_worker   ``[W]``        one value per worker row (pre-mixing)
  per_bucket   ``[m]``        one value per mixed row (post-bucketing)
  per_iter     ``[T]``        one value per inner-loop iteration
  per_iter_bucket ``[T, m]``  inner-loop series of per-bucket values
  counter      static host-side int (bytes, sizes — constants of the layout)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

KINDS = ("scalar", "per_worker", "per_bucket", "per_iter", "per_iter_bucket",
         "counter")
PHASES = ("aggregate", "sync", "train", "sim", "serve", "bench", "probe")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    phase: str   # one of PHASES
    kind: str    # one of KINDS
    doc: str

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown phase {self.phase!r} for {self.name}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r} for {self.name}")


_REGISTRY: Dict[str, MetricSpec] = {}


def register(name: str, phase: str, kind: str, doc: str) -> MetricSpec:
    spec = MetricSpec(name, phase, kind, doc)
    existing = _REGISTRY.get(name)
    if existing is not None and existing != spec:
        raise ValueError(f"metric {name!r} already registered as {existing}")
    _REGISTRY[name] = spec
    return spec


def get_metric(name: str) -> MetricSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unregistered metric {name!r} — add it to "
            f"repro_torch/telemetry/registry.py"
        ) from None


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def catalogue() -> Tuple[MetricSpec, ...]:
    """All registered metrics, name-sorted (the docs table / JSONL schema)."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


# --------------------------------------------------------------- aggregate
# RFA (smoothed Weiszfeld)
register("rfa_resid_norms", "aggregate", "per_iter_bucket",
         "residual norms ||v_t - y_i|| per Weiszfeld iteration")
register("rfa_residual", "aggregate", "per_iter",
         "geometric-median objective sum_i ||v_t - y_i|| per iteration")
register("rfa_iters", "aggregate", "counter", "Weiszfeld iteration count T")

# CCLIP / ACClip
register("cclip_lam", "aggregate", "per_iter_bucket",
         "clip weights min(1, tau/||y_i - v_t||) per iteration")
register("cclip_clip_frac", "aggregate", "per_iter",
         "fraction of inputs clipped (lam < 1) per iteration")
register("cclip_tau", "aggregate", "per_iter",
         "clipping radius per iteration (constant for CCLIP, "
         "median-adaptive for ACClip)")

# Krum
register("krum_scores", "aggregate", "per_bucket",
         "Krum score: summed sq-distance to the n-f-2 nearest neighbours")
register("krum_selected", "aggregate", "scalar",
         "index of the minimum-score (selected) input")

# coordinatewise rules
register("cm_worker_dev", "aggregate", "per_bucket",
         "mean |y_i - median| per input — ALIE rows sit suspiciously "
         "CLOSE to the median (see docs/observability.md)")
register("tm_trim_frac", "aggregate", "per_bucket",
         "fraction of coordinates where input i fell in a trimmed band "
         "(the compressed trim mask)")

# composition-level
register("worker_weights", "aggregate", "per_worker",
         "final per-worker combination weights M^T c")
register("bucket_dispersion", "aggregate", "per_bucket",
         "||y_i - mean_j y_j||^2 per mixed row — the dispersion bucketing "
         "is supposed to shrink by s")

# -------------------------------------------------------------------- sync
register("sync_n_workers", "sync", "counter", "worker rows W entering the sync")
register("sync_n_params", "sync", "counter", "true parameter count")
register("sync_n_pad", "sync", "counter", "padded packed-buffer columns")
register("sync_ingress_bytes", "sync", "counter",
         "packed-buffer ingress payload W * n_pad * 4")
register("sync_egress_bytes", "sync", "counter",
         "egress payload: n_pad*4 replicated, n_params*4 param-sharded")

# ------------------------------------------------------------- train / sim
register("loss", "train", "scalar", "mean worker training loss")
register("agg_norm", "sim", "scalar", "L2 norm of the robust aggregate")
register("grad_norm_mean", "sim", "scalar", "mean per-worker gradient norm")
register("byz_mask", "sim", "per_worker",
         "ground-truth Byzantine mask of this round's rows (simulation only)")
register("zeta_sq", "sim", "scalar",
         "empirical inter-worker gradient heterogeneity of the good workers")
register("byz_in_cohort", "sim", "scalar",
         "Byzantine clients sampled into this round's cohort")

# ------------------------------------------------------------------- serve
register("serve_queue_depth", "serve", "scalar", "requests waiting for a slot")
register("serve_active_slots", "serve", "scalar", "slots decoding a request")
register("serve_tokens_total", "serve", "counter", "tokens generated so far")
register("serve_steps_total", "serve", "counter", "engine decode steps so far")
register("serve_admit_latency_s", "serve", "scalar",
         "submit -> slot admission latency (seconds)")
register("serve_decode_step_s", "serve", "scalar",
         "wall time of one engine decode step (seconds)")
register("serve_tokens_per_s", "serve", "scalar",
         "generation throughput over the ring-buffer window")
