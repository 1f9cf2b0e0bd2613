"""Gemma-7B — GeGLU, head_dim 256, tied embeddings [arXiv:2403.08295].

(The 2B sibling uses MQA; the assigned 7B uses kv=16 = MHA.)
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="geglu",
    tie_embeddings=True,
    fsdp=True,
    # the tied embed doubles as the LM head: the reference's sharding rules
    # keep d_model on the model axis and FSDP the 256k vocab rows over data
    # (carried here as data; the port does not shard yet)
    sharding_overrides=(("^embed$", ("data", "model")),),
    momentum_mode="server",
    remat="full",
    long_context="window",
    long_context_window=8192,
    source="arXiv:2403.08295",
)
