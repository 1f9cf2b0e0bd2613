"""Qwen1.5-32B — dense, QKV bias, full MHA (kv=40) [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_kind="swiglu",
    fsdp=True,
    momentum_mode="server",
    remat="full",
    long_context="window",
    long_context_window=8192,
    source="hf:Qwen/Qwen1.5-0.5B",
)
