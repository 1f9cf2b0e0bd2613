"""Config system (port of ``repro/configs/base.py``).

``ModelConfig`` describes an architecture declaratively (every field of the
reference's, so a config file copies across as data); the dense decoder in
``repro_torch/models/transformer.py`` consumes it. ``ByzConfig`` configures
the paper's technique. ``InputShape`` names the reference's input shapes.
The mesh and training configs come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# (mixer_kind, ff_kind) per layer within one period.
#   mixer_kind in {"attn", "ssm"}; ff_kind in {"mlp", "moe", "none"}.
LayerSpec = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # --- layer pattern (repeated every `period` layers). Empty => derived.
    pattern: Tuple[LayerSpec, ...] = ()

    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # --- attention details
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_impl: str = "auto"  # auto | xla | blockwise
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    logit_softcap: float = 0.0  # gemma-style final-logit softcap (0 = off)

    # --- multimodal stubs (frontends not implemented in the reference either)
    n_prefix_tokens: int = 0  # vlm patch embeds / audio conditioning prefix
    n_codebooks: int = 0      # musicgen EnCodec codebooks (0 = plain LM)

    # --- numerics / memory
    dtype: str = "bfloat16"
    opt_m_dtype: str = "float32"  # optimizer momentum storage (bf16 for 1T)
    remat: str = "none"  # none | full
    scan_unroll: int = 1  # the reference's layer-scan unroll; the port loops
    fsdp: bool = False    # shard params over the data axis too
    # per-arch sharding overrides: ((path_regex, spec_entries), ...), read by
    # the reference's sharding rules; carried as data here
    sharding_overrides: Tuple[Tuple[str, Tuple], ...] = ()
    # momentum bookkeeping mode for Byzantine training
    momentum_mode: str = "worker"  # worker (Alg. 2) | server (Remark 7)

    # --- long-context policy for the long_500k decode shape
    #   "full"    : keep the full-length KV cache (SSM / small-cache archs)
    #   "window"  : sliding-window KV cache (dense archs)
    #   "state"   : O(1) recurrent state only (pure SSM)
    long_context: str = "window"
    long_context_window: int = 8192

    source: str = ""  # citation

    # ------------------------------------------------------------ derived
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def pattern_(self) -> Tuple[LayerSpec, ...]:
        if self.pattern:
            return self.pattern
        if self.family == "ssm":
            return (("ssm", "none"),)
        if self.family == "moe" or (self.n_experts > 0):
            return (("attn", "moe"),)
        return (("attn", "mlp"),)

    @property
    def period(self) -> int:
        return len(self.pattern_)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by "
                             f"pattern period {self.period}")
        return self.n_layers // self.period


@dataclasses.dataclass(frozen=True)
class ByzConfig:
    """The paper's technique, as a first-class training feature."""

    aggregator: str = "mean"        # mean | krum | cm | rfa | cclip | acclip | tm
    mixing: str = "none"            # none | bucketing | resampling | fixed_grouping
    s: int = 2                      # mixing factor (Alg. 1)
    delta: float = 0.0              # assumed Byzantine fraction
    worker_momentum: float = 0.9    # beta of Alg. 2 (0 = off)
    momentum_convention: str = "ema"
    cclip_tau: float = 10.0         # base clipping radius, scaled per App. A.2.1
    cclip_tau_scaling: str = "linear"
    attack: str = "none"
    attack_kwargs: tuple = ()
    n_byzantine: int = 0

    def make_aggregator(self, n_workers: int):
        from repro_torch.core.aragg import RobustAggregator
        from repro_torch.core.momentum import cclip_radius

        kwargs = {}
        if self.aggregator == "cclip":
            kwargs["tau"] = cclip_radius(
                self.worker_momentum, self.cclip_tau, self.cclip_tau_scaling
            )
        if self.aggregator == "krum":
            kwargs["n_byzantine"] = self.n_byzantine
        if self.aggregator == "tm":
            kwargs["n_trim"] = max(1, self.n_byzantine)
        return RobustAggregator.from_spec(
            self.aggregator,
            mixing=self.mixing,
            s=self.s,
            delta=self.delta,
            n_workers=n_workers,
            **kwargs,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
