"""Serving runtime: slot-based continuous batching over ``decode_step``."""

from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
