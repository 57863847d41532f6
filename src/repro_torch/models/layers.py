"""Shared layer primitives: norms, RoPE, MLPs, embeddings, initializers.

Port of ``repro.models.layers``: plain functions over nested-dict params
with the JAX package's keys and layouts (weights (K, N), y = x @ W).

The norms run in a hand-written row-stable kernel (``kernels.row_norm``):
a row comes out bitwise the same however many rows share the call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import row_norm
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# ------------------------------------------------------------- norms -------

def init_norm(cfg: ModelConfig, d: int, device, lead=()):
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(lead + (d,), **f32),
                "bias": torch.zeros(lead + (d,), **f32)}
    init = torch.zeros if cfg.norm_plus_one else torch.ones
    return {"scale": init(lead + (d,), **f32)}


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    if cfg.norm_type == "layernorm":
        return row_norm.row_norm(x, p["scale"], p["bias"], eps)
    return row_norm.row_norm(x, p["scale"], eps=eps,
                             plus_one=cfg.norm_plus_one)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (qwen3): x (..., head_dim)."""
    return row_norm.row_norm(x, scale, eps=eps)


# -------------------------------------------------------------- RoPE -------

def rope_frequencies(cfg: ModelConfig, positions):
    """positions (...,) int -> (cos, sin) of shape (..., rot_dim // 2)."""
    rot = int(cfg.hd * cfg.rope_pct)
    rot -= rot % 2
    ar = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (cfg.rope_theta ** (ar / rot))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, cfg: ModelConfig):
    """Half-split (not interleaved) rotation of the first rot dims.
    x (..., H, hd); cos/sin broadcastable (..., rot // 2)."""
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    c = cos[..., None, :] if x.ndim == cos.ndim + 1 else cos
    s = sin[..., None, :] if x.ndim == sin.ndim + 1 else sin
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------- MLP -------

def init_mlp(cfg: ModelConfig, gen, d: int, f: int, device, lead=()):
    """Gated MLPs (swiglu, geglu) have w_gate, w_up and w_down; the plain
    gelu MLP (whisper) w_up and w_down."""
    dt = dtype_of(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (_normal(gen, lead + (d, f), device) * s_in).to(dt)
    p["w_up"] = (_normal(gen, lead + (d, f), device) * s_in).to(dt)
    p["w_down"] = (_normal(gen, lead + (f, d), device) * s_out).to(dt)
    return p


def make_matmul(cfg: ModelConfig, tables=None):
    """dense_fn factory for apply_mlp / attention: with ``cfg.dbpim`` set
    and per-layer kernel tables (``sparsity.sparse_linear
    .build_kernel_tables``), the packed projections run on the kernel of
    ``cfg.dbpim_mode``; otherwise None (plain matmuls), so call sites can
    pass the result straight through. The stacked serving path threads
    ``StackedKernelTables`` instead."""
    if not getattr(cfg, "dbpim", False) or not tables:
        return None
    from repro_torch.sparsity.sparse_linear import kernel_dense_fn
    return kernel_dense_fn(tables)


def promote(*ts):
    """``ts`` cast to their common dtype, the type promotion a jnp product
    applies to mixed operands (a no-op when they agree): the lock-step
    int8 "serve" step (``launch.steps``) dequantizes its projections to
    bf16 whatever cfg.dtype, and an f32 activation then meets a bf16
    weight."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def plain_mm(w, v, name=None):
    """The plain projection ``v @ w`` of the dense_fn(w, x, name) hooks, in
    the promoted dtype."""
    v, w = promote(v, w)
    return v @ w


def apply_mlp(p, x, cfg: ModelConfig, dense_fn=None):
    """Gated MLP (swiglu or geglu) or the plain gelu MLP (whisper:
    gelu(x @ w_up) @ w_down, tanh approximation). dense_fn(w, x, name) lets
    the joint-sparse path intercept matmuls."""
    mm = dense_fn or plain_mm
    if cfg.mlp_type == "gelu":
        h = F.gelu(mm(p["w_up"], x, "w_up"), approximate="tanh")
        return mm(p["w_down"], h, "w_down")
    gate = mm(p["w_gate"], x, "w_gate")
    g = (F.silu(gate) if cfg.mlp_type == "swiglu"
         else F.gelu(gate, approximate="tanh"))
    return mm(p["w_down"], g * mm(p["w_up"], x, "w_up"), "w_down")


# --------------------------------------------------------- embeddings ------

def init_embeddings(cfg: ModelConfig, gen, device):
    dt = dtype_of(cfg)
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), device).to(dt)}
    if not cfg.tie_embeddings:
        p["out"] = (_normal(gen, (cfg.d_model, cfg.vocab_size), device)
                    * cfg.d_model ** -0.5).to(dt)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig):
    """The token rows of ``p["tok"]``; with ``cfg.embed_scale`` (gemma)
    times sqrt(d_model) rounded to their dtype, as the reference's. The
    scale is a host number: a tensor made on the card would be a copy
    from the host, which a CUDA graph capture refuses."""
    x = p["tok"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def logits_from_hidden(p, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["out"]


def cross_entropy(logits, labels):
    """Mean token cross-entropy; labels < 0 are masked (the divisor is the
    count of the others, at least 1). float32 logsumexp less the gold
    logit: the reference contracts the logits with a one-hot (a gather
    would all-gather vocab-sharded logits on its mesh); on one card the
    gold logit is a gather, the same value in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
