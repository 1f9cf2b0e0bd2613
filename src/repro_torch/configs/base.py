"""Config system (port of ``repro/configs/base.py``).

``ModelConfig`` describes an architecture declaratively (every field of the
reference's, so a config file copies across as data, and its parameter
count); the decoder in
``repro_torch/models/transformer.py`` consumes it. ``ByzConfig`` configures
the paper's technique. ``InputShape`` names the reference's input shapes.
``MeshConfig`` and ``TrainConfig`` are the reference's, as data: the port
has no GSPMD mesh, and the ``mesh`` its entry points take is a
``torch.distributed`` process group or ``None`` (``launch/mesh.py``).
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

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula as it stands. For an SSM layer it counts a
        ``norm2`` that an ``("ssm", "none")`` layer lacks and leaves out
        ``dt_bias`` and ``conv_b``, so it differs from the tree's own count
        there (``ROADMAP.md``, Queue 3)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        total = V * D  # embeddings
        if self.n_codebooks:
            total = self.n_codebooks * V * D
        n_mlp_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp_kind]
        per_kind = {}
        per_kind["attn"] = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D + (
            (H + 2 * KV) * dh if self.qkv_bias else 0
        )
        per_kind["mlp"] = n_mlp_mats * D * F
        if self.n_experts:
            Fe = self.d_ff_expert or F
            per_kind["moe"] = (
                D * self.n_experts
                + self.n_experts * n_mlp_mats * D * Fe
                + self.n_shared_experts * n_mlp_mats * D * Fe
            )
        if self.family in ("ssm", "hybrid"):
            Din, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            G = 1
            conv_ch = Din + 2 * G * N
            per_kind["ssm"] = (
                D * (2 * Din + 2 * G * N + Hs)  # in_proj (z,x,B,C,dt)
                + conv_ch * self.conv_kernel
                + Hs * 2  # A_log, D skip
                + Din     # gated norm
                + Din * D  # out_proj
            )
        per_kind["none"] = 0
        for mixer, ff in self.pattern_:
            total += (per_kind[mixer] + per_kind.get(ff, 0) + 2 * D) * self.n_periods
        total += D  # final norm
        if not self.tie_embeddings:
            total += D * V * max(1, self.n_codebooks or 1)
        return total


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
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def worker_axes(self) -> Tuple[str, ...]:
        """Mesh axes that enumerate Byzantine 'workers' (= DP groups)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    byz: ByzConfig = dataclasses.field(default_factory=ByzConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seq_len: int = 4096
    global_batch: int = 256
    lr: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "sgdm"  # sgdm | adamw
    beta1: float = 0.9
    beta2: float = 0.95
    steps: int = 100
    seed: int = 0
