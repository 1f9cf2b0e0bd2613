"""Mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060].

d_inner = 2*768 = 1536, 24 SSD heads of dim 64, state N=128. Decode keeps an
O(1) recurrent state, so long_500k runs natively (long_context="state").
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    conv_kernel=4,
    tie_embeddings=True,
    long_context="state",
    source="arXiv:2405.21060",
)
