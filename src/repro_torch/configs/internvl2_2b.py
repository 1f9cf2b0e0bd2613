"""InternVL2-2B language decoder (InternLM2-1.8B arch) [arXiv:2404.16821].

The InternViT-300M vision encoder + MLP projector are stubs, as in the
reference: ``input_specs`` supplies 256 precomputed patch embeddings per
image consumed as a prefix before the text tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    n_prefix_tokens=256,
    mlp_kind="swiglu",
    long_context="window",
    long_context_window=8192,
    source="arXiv:2404.16821",
)
