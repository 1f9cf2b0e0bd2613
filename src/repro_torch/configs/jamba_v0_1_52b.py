"""Jamba v0.1 — 52B hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Period-8 pattern: one attention layer per 8 (offset 4), MoE every other
layer. Jamba v0.1 uses Mamba-1 (d_state 16); we implement the Mamba-2/SSD
form with N=16. Only 4 attention layers -> the full-length
KV cache at batch 1 is small even at 500k, so long_context="full".
"""

from repro_torch.configs.base import ModelConfig

_PERIOD = (
    ("ssm", "mlp"),
    ("ssm", "moe"),
    ("ssm", "mlp"),
    ("ssm", "moe"),
    ("attn", "mlp"),
    ("ssm", "moe"),
    ("ssm", "mlp"),
    ("ssm", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PERIOD,
    n_experts=16,
    experts_per_token=2,
    d_ff_expert=14336,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    mlp_kind="swiglu",
    fsdp=True,
    momentum_mode="server",
    remat="full",
    long_context="full",
    source="arXiv:2403.19887",
)
