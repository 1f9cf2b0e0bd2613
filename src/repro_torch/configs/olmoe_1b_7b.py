"""OLMoE-1B-7B — 64 experts, top-8 routing, 1B active params [arXiv:2409.02060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    d_ff_expert=1024,
    mlp_kind="swiglu",
    long_context="window",
    long_context_window=8192,
    source="arXiv:2409.02060",
)
