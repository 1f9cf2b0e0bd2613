"""Serving prefill step (port of ``repro/distributed/steps.py``, the part
the serving slice runs).

The reference's train, decode and mesh-sharded steps belong to the training
slice (``ROADMAP.md`` Queue 1); here the prefill runs on one device.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg, mesh=None, last_only: bool = True, device=None) -> Callable:
    """Serving prefill: ``prefill(params, batch) -> fp32 logits``.
    ``last_only`` (default) unembeds ONLY the final position, the next-token
    logits a server needs ([B, 1, V]); the full-sequence [B, S, V] fp32
    logits would dominate peak memory. ``batch["tokens"]`` ([B, S] ints) is
    moved to ``device``, where the parameters must lie."""
    if mesh is not None:
        raise NotImplementedError("a sharded prefill is queued in ROADMAP.md, Queue 1")
    dev = resolve_device(device)

    def prefill(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        h, _ = tfm.forward_hidden(params, cfg, tokens, prefix_embeds=batch.get("prefix_embeds"))
        if last_only:
            h = h[:, -1:]
        return tfm.unembed(params, cfg, h)

    return prefill
