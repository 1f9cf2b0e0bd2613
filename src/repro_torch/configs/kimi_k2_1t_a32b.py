"""Kimi K2 — trillion-parameter MoE, 32B active (paper-table entry)
[arXiv:2501.kimi2].

384 experts top-8 + 1 shared expert, 61 layers, d_model 7168, GQA kv=8 with
head_dim 128 (we use GQA per the assignment; K2's MLA is out of scope).
Uses server momentum (paper Remark 7) + FSDP: per-worker momentum state at
1T params is infeasible (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    mlp_kind="swiglu",
    fsdp=True,
    momentum_mode="server",
    opt_m_dtype="bfloat16",  # fp32 momentum (16 GB/chip) cannot fit v5e
    remat="full",
    long_context="window",
    long_context_window=8192,
    source="arXiv:2501.kimi2",
)
