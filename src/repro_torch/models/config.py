"""Model configuration for the 10 assigned architectures.

One frozen dataclass drives parameter creation, the forward pass, sharding
rules, DB-PIM sparsity instrumentation, and the dry-run input specs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None        # default d_model // n_heads
    qk_norm: bool = False                 # qwen3
    mlp_type: str = "swiglu"              # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"            # rmsnorm | layernorm
    norm_plus_one: bool = False           # gemma's (1 + w) RMSNorm
    embed_scale: bool = False             # gemma scales embeddings by sqrt(d)
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                 # stablelm partial rotary
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False          # arctic: dense FFN + MoE in parallel
    moe_every: int = 1                    # jamba: MoE on every 2nd layer
    capacity_factor: float = 1.25

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0                  # jamba: 1 attn layer per `period`
    attn_index: int = 0                   # position of attn inside the period

    # attention windowing (mixtral SWA)
    window: int = 0                       # 0 = full causal attention

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend output length
    frontend: str = "none"                # none | audio_stub | vision_stub
    n_patches: int = 0                    # vlm stub patch count

    dtype: str = "bfloat16"

    # DB-PIM integration
    dbpim: bool = False                   # FTA-quantized projections
    dbpim_value_sparsity: float = 0.6
    dbpim_mode: str = "joint"             # dense | value | bit | joint:
                                          # which sparsity level(s) the
                                          # serving kernels exploit

    # serving prefill: False (default) lets SSM chunked prefill use the
    # parallel SSD form — one in/out projection read per chunk instead of
    # per token, tolerance-equivalent to sequential decode (models.ssm.
    # PARALLEL_PREFILL_ATOL); True forces the exact per-token recurrence
    # (bit-identical to decode, C x the projection traffic)
    prefill_exact: bool = False

    # training
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save matmul outputs)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic support: SSM, hybrid, or sliding-window attention
        (the dry run's long_500k cells)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def serving_capabilities(self):
        """What the serving stack supports for this config, derived from
        the segment layout (models.segments.ServingCapabilities): segment
        descriptors, packable projections, prefill modes. Single source
        of truth."""
        from .segments import serving_capabilities
        return serving_capabilities(self)

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell of the dry run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    microbatches: int = 1


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + per-layer weights)."""
    d, f = cfg.d_model, cfg.d_ff
    attn = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d) \
        if cfg.n_heads else 0
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = 3 * d * f
    else:
        mlp = 2 * d * f
    per_layer = 0
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        conv_ch = d_in + 2 * cfg.ssm_state
        per_layer = (d * (2 * d_in + 2 * cfg.ssm_state + nh)
                     + conv_ch * cfg.ssm_conv_width + 2 * nh + d_in
                     + d_in * d) * cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
        n_ssm = cfg.n_layers - n_attn
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        ssm_l = (d * (2 * d_in + 2 * cfg.ssm_state + nh)
                 + (d_in + 2 * cfg.ssm_state) * cfg.ssm_conv_width
                 + 2 * nh + d_in + d_in * d)
        n_moe = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
        n_dense = cfg.n_layers - n_moe
        per_layer = (n_attn * attn + n_ssm * ssm_l
                     + n_moe * cfg.n_experts * mlp + n_dense * mlp)
    elif cfg.n_experts:
        moe = cfg.n_experts * mlp + d * cfg.n_experts
        if cfg.dense_residual:
            moe += mlp
        per_layer = (attn + moe) * cfg.n_layers
    else:
        per_layer = (attn + mlp) * cfg.n_layers
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    enc = 0
    if cfg.is_encdec:
        enc = cfg.encoder_layers * (attn + mlp)
        per_layer += cfg.n_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim
                                     + cfg.q_dim * d)   # cross-attention
    return per_layer + emb + enc


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    full = param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    mlp = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * f
    if cfg.family == "hybrid":
        n_moe = cfg.n_layers // cfg.moe_every
    else:
        n_moe = cfg.n_layers
    inactive = n_moe * (cfg.n_experts - cfg.top_k) * mlp
    return full - inactive
