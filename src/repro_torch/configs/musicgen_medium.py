"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec / T5 text conditioner are stubs, as in the reference:
``input_specs`` supplies 4 parallel codebook token streams (vocab 2048 each,
summed embeddings, per-codebook output heads — the flattened/delay codebook
interleave pattern collapses to this backbone) plus 64 precomputed
conditioning embeddings consumed as a prefix (we use prefix conditioning in
place of MusicGen's cross-attention).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    n_prefix_tokens=64,
    mlp_kind="gelu",
    qkv_bias=False,
    long_context="window",
    long_context_window=8192,
    source="arXiv:2306.05284",
)
