"""The paper's own experimental model (MNIST MLP; App. Table 5)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-mnist-mlp",
    family="mlp",
    n_layers=2,
    d_model=128,
    n_heads=0,
    n_kv_heads=0,
    d_ff=128,
    vocab_size=10,  # classes
    dtype="float32",
    source="ICLR2022 bucketing paper, App. A.1.1",
)
