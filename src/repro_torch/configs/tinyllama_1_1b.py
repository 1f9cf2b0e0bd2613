"""TinyLlama 1.1B — llama2-architecture small model [arXiv:2401.02385]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    mlp_kind="swiglu",
    rope_theta=10000.0,
    long_context="window",
    long_context_window=8192,
    source="arXiv:2401.02385",
)
