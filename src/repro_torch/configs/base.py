"""Model and run configs and the arch registry of the port.

A copy of the JAX package's ``ModelConfig`` (with ``param_count``, the
estimate model-FLOPs figures use, not the count of the spec tree) and of
the run configs
(``ShapeConfig``, ``HornConfig``, ``TopologyConfig``, ``RunConfig``) with
the same field names and defaults, the assigned shape cells (``SHAPES``,
which the sharding rules' shape-aware fallbacks read), so a test builds the same config on
both sides, its layer kinds,
``register``/``get_model_config`` and ``reduced``.  The registry covers the
archs the port runs so far: qwen3-1.7b, qwen1.5-4b, gemma2-27b, gemma3-4b,
mamba2-2.7b, the MoE, multimodal-prefix and hybrid families
(phi3.5-moe-42b, llama4-maverick-400b, llava-next-34b,
jamba-1.5-large-398b), the encoder-decoder whisper-base (refused by the
serve CLI, as the JAX engine refuses it) and the paper's MNIST classifier
horn-mnist (family "mlp": trained by ``launch.train``'s own branch,
refused by the serve CLI).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

ATTN = "attn"          # full (global) attention
LOCAL = "local"        # sliding-window attention
MAMBA = "mamba"        # Mamba2 SSD mixer


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact public configs; see
    configs/<id>.py)."""

    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants -------------------------------------------------
    qk_norm: bool = False            # qwen3: RMSNorm on q,k per head
    qkv_bias: bool = False           # qwen1.5
    attn_logit_softcap: Optional[float] = None    # gemma2: 50.0
    final_logit_softcap: Optional[float] = None   # gemma2: 30.0
    query_scale: Optional[float] = None           # gemma2: (d_model/heads)^-0.5
    sliding_window: int = 4096       # window for LOCAL layers
    use_rope: bool = True
    rope_theta: float = 1e6

    # --- stack structure -----------------------------------------------------
    # One superblock of the repeating layer pattern; num_layers =
    # k * len(pattern) + r, remainder layers take pattern[:r].
    layer_pattern: Tuple[str, ...] = (ATTN,)
    moe_period: int = 0
    moe_offset: int = 0

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- enc-dec / multimodal --------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500
    num_patches: int = 0

    # --- positions -------------------------------------------------------------
    learned_pos: bool = False
    max_pos: int = 0

    # --- misc -----------------------------------------------------------------
    mlp_gated: bool = True           # SwiGLU/GeGLU-style gated MLP
    act: str = "silu"                # silu | gelu | relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"          # embedding / residual-stream dtype
    post_sublayer_norm: bool = False  # gemma-style norms after sublayers

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def has_attention(self) -> bool:
        return any(k in (ATTN, LOCAL) for k in self.layer_pattern)

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def pattern_remainder(self) -> int:
        return self.num_layers % len(self.layer_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer mixer kinds for the full stack."""
        full = self.layer_pattern * self.pattern_repeats
        return tuple(full) + self.layer_pattern[: self.pattern_remainder]

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe_period <= 0:
            return False
        return idx % self.moe_period == self.moe_offset

    # Parameter count (embedding + stack), used for 6ND model-FLOPs.
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, hd, ff = (self.d_model, self.num_heads, self.num_kv_heads,
                            self.head_dim, self.d_ff)
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            n += d  # pre-norm
            if kind in (ATTN, LOCAL):
                n += d * h * hd + 2 * d * kv * hd + h * hd * d  # q,k,v,o
                if self.qkv_bias:
                    n += (h + 2 * kv) * hd
                if self.qk_norm:
                    n += 2 * hd
            elif kind == MAMBA:
                d_in = self.ssm_expand * d
                nh = d_in // self.ssm_head_dim
                proj_in = 2 * d_in + 2 * self.ssm_state + nh   # z,x,B,C,dt
                n += d * proj_in                                # in_proj
                n += self.ssm_conv_width * (d_in + 2 * self.ssm_state)
                n += 2 * nh + nh * 0 + d_in * d                 # A,D(+dt_bias), out_proj
                n += d_in                                       # gated norm
            if self.layer_is_moe(i):
                e = self.experts_per_tok if active_only else self.num_experts
                mult = 3 if self.mlp_gated else 2
                n += e * mult * d * self.moe_ff + self.num_experts * d  # experts + router
                n += d  # ffn pre-norm
            else:
                mult = 3 if self.mlp_gated else 2
                n += mult * d * ff
                n += d
        n += d  # final norm
        if self.is_encoder_decoder:
            # encoder stack (self-attn + mlp) + decoder cross-attn blocks
            enc = self.num_encoder_layers * (
                d * h * hd + 2 * d * kv * hd + h * hd * d
                + (3 if self.mlp_gated else 2) * d * ff + 2 * d)
            xattn = self.num_layers * (d * h * hd + 2 * d * kv * hd + h * hd * d + d)
            n += enc + xattn
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class HornConfig:
    """Horn's collective & parallel dropout (the paper's technique).

    ``num_groups`` worker groups each draw an independent structured
    sub-model (block-aligned neuron dropout) per step; updates are
    batch-averaged."""

    enabled: bool = True
    num_groups: int = 0              # 0 => one group per data-parallel shard
    keep_input: float = 0.8          # paper: input-layer keep rate
    keep_hidden: float = 0.5         # paper: hidden-layer keep rate
    block_size: int = 128            # neuron blocks (beyond-paper)
    mask_attention_heads: bool = False   # also drop whole attention heads
    seed_salt: int = 0x484F524E      # "HORN"


@dataclass(frozen=True)
class TopologyConfig:
    """Horn topology choice: how groups merge updates (paper §2)."""

    kind: str = "allreduce"          # allreduce | zero1 | local_sgd
    local_sgd_period: int = 1        # H: steps between group merges
    grad_compression: str = "none"   # none | int8 (error feedback)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    horn: HornConfig = field(default_factory=HornConfig)
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    optimizer: str = "sgdm"          # sgdm (paper) | adamw
    learning_rate: float = 0.3
    momentum: float = 0.98
    weight_decay: float = 0.0
    remat: str = "block"             # none | block (remat each block)
    microbatches: int = 1            # gradient accumulation steps
    multi_pod: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_model_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import the config modules once (registration side effect)
    import importlib
    for mod in ("qwen3_1p7b", "qwen1p5_4b", "gemma2_27b", "gemma3_4b",
                "mamba2_2p7b", "llava_next_34b", "jamba_1p5_large",
                "whisper_base", "phi3p5_moe", "llama4_maverick",
                "horn_mnist"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (tiny dims, same
    structure)."""
    pattern = cfg.layer_pattern
    # keep at least one full superblock (so every mixer kind is exercised)
    num_layers = len(pattern) * max(1, min(2, cfg.pattern_repeats))
    base = dict(
        name=cfg.name + "-reduced",
        family=cfg.family,
        num_layers=num_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias,
        attn_logit_softcap=cfg.attn_logit_softcap,
        final_logit_softcap=cfg.final_logit_softcap,
        sliding_window=16,
        use_rope=cfg.use_rope,
        layer_pattern=pattern,
        moe_period=cfg.moe_period,
        moe_offset=cfg.moe_offset,
        num_experts=min(cfg.num_experts, 4),
        experts_per_tok=min(cfg.experts_per_tok, 2),
        moe_d_ff=128 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_expand=cfg.ssm_expand,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        ssm_conv_width=cfg.ssm_conv_width,
        is_encoder_decoder=cfg.is_encoder_decoder,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq=16,
        num_patches=min(cfg.num_patches, 8),
        mlp_gated=cfg.mlp_gated,
        act=cfg.act,
        norm=cfg.norm,
        tie_embeddings=cfg.tie_embeddings,
        post_sublayer_norm=cfg.post_sublayer_norm,
    )
    base.update(overrides)
    return ModelConfig(**base)
