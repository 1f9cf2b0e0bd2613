"""Architecture registry (port of ``repro/configs/__init__.py``).

``get_config(name)`` returns the full (paper-scale) ``ModelConfig`` of a
ported architecture; ``smoke_config(name)`` the reduced same-family variant
the CPU tests use. The port carries the dense configs (TinyLlama,
Qwen2.5-14B, Gemma-7B), the MoE configs (OLMoE-1B-7B, Kimi K2) and the
paper's own MNIST MLP; the SSM, hybrid, VLM and audio families of the
reference are queued in ``ROADMAP.md`` (Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (gemma_7b, kimi_k2_1t_a32b, olmoe_1b_7b, paper_mnist,
                                 qwen2_5_14b, tinyllama_1_1b)
from repro_torch.configs.base import (INPUT_SHAPES, ByzConfig, InputShape, MeshConfig,
                                      ModelConfig, TrainConfig)

_CONFIGS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (tinyllama_1_1b, olmoe_1b_7b, kimi_k2_1t_a32b,
                                      qwen2_5_14b, gemma_7b, paper_mnist)
}


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"arch {name!r} is not ported (ported: {sorted(_CONFIGS)}); "
                       "the other families are queued in ROADMAP.md, Queue 1")
    return _CONFIGS[name]


def list_archs(include_paper: bool = False) -> List[str]:
    out = sorted(n for n in _CONFIGS if n != "paper-mnist-mlp")
    if include_paper:
        out.append("paper-mnist-mlp")
    return out


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant: <= 2 layers (one short period for the
    hybrid), d_model <= 512, <= 4 experts — runs a forward/train step on CPU."""
    cfg = get_config(name)
    ch: Dict = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=512,
        vocab_size=512,
        head_dim=64 if cfg.head_dim else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=256,
        dtype="float32",  # CPU smoke tests check numerics in fp32
        remat="none",
    )
    if cfg.n_experts:
        ch.update(
            n_experts=4,
            experts_per_token=2,
            d_ff_expert=128,
            n_shared_experts=min(cfg.n_shared_experts, 1),
        )
    if cfg.family in ("ssm", "hybrid"):
        ch.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=16)
    if cfg.pattern:  # hybrid: shrink to a 2-layer period keeping both mixers
        ch["pattern"] = (("ssm", "moe"), ("attn", "mlp"))
        ch["n_layers"] = 2
    if cfg.n_prefix_tokens:
        ch["n_prefix_tokens"] = 8
    return dataclasses.replace(cfg, **ch)


__all__ = [
    "ModelConfig",
    "ByzConfig",
    "InputShape",
    "INPUT_SHAPES",
    "MeshConfig",
    "TrainConfig",
    "get_config",
    "smoke_config",
    "list_archs",
]
