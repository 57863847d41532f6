"""Parameter construction, the whisper encoder, the full-sequence forward
and the shared block tail.

Port of ``repro.models.transformer``: every decoder the segment layout
describes (``models.segments``): dense-attention stacks (full causal or
sliding-window attention), attention + MoE stacks (mixtral, arctic),
attention-free SSM stacks (mamba2), hybrid stacks of interleaved SSM,
attention, MLP and MoE layers (jamba), the whisper decoder with
cross-attention beside its encoder (``encode``), and pixtral's vision
stub (precomputed patch embeddings projected by ``patch_proj`` and
prepended to the tokens; ``forward`` only). Layer stacks are
parameter-stacked with a leading layer axis, as in the JAX package;
``forward`` and the decode loops in ``models.decode`` walk them layer by
layer where JAX scans. Params come from a ``torch.Generator`` on the
device, with the JAX package's shapes and scales (its numbers differ: the
tests feed JAX-initialised params through ``repro_torch.weights``
instead). The training loss (``loss_fn``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (_normal, apply_mlp, apply_norm, dtype_of, embed_tokens,
                     init_embeddings, init_mlp, init_norm,
                     logits_from_hidden)
from .segments import Segment, decoder_layout, encoder_layout

#: the frontends of the configs: none, whisper's stub frames (the encoder's
#: input) and pixtral's stub patch embeddings (``forward``'s
#: ``frontend_embeds``; decode and prefill chunks serve pixtral text-only,
#: as the reference does)
FRONTENDS = ("none", "audio_stub", "vision_stub")


def _check_supported(cfg: ModelConfig):
    """The decoder's segments (every mixer / FFN / cross-attention
    composition of the segment layout is served); raises for a frontend
    no config has."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} not in "
                         f"{FRONTENDS}")
    return decoder_layout(cfg)


def _init_block(cfg: ModelConfig, gen, dev, seg: Segment, lead,
                expert_sink=None):
    """One segment's stacked layers: norm + mixer, cross-attention (the
    whisper decoder), then the FFN if the segment has one (the JAX
    ``_init_block``). ``expert_sink`` takes the MoE expert slices as they
    are drawn (``moe.init_moe``)."""
    p = {"norm1": init_norm(cfg, cfg.d_model, dev, lead)}
    if seg.mixer == "attn":
        p["attn"] = attn_mod.init_attention(cfg, gen, dev, lead)
    else:
        p["ssm"] = ssm_mod.init_ssm(cfg, gen, dev, lead)
    if seg.cross:
        p["norm_x"] = init_norm(cfg, cfg.d_model, dev, lead)
        p["xattn"] = attn_mod.init_attention(cfg, gen, dev, lead)
    if seg.ffn == "moe":
        p["norm2"] = init_norm(cfg, cfg.d_model, dev, lead)
        sink = None if expert_sink is None else (
            lambda name, l, e, w: expert_sink(seg, name, l, e, w))
        p["moe"] = moe_mod.init_moe_block(cfg, gen, dev, lead, sink)
    elif seg.ffn == "mlp":
        p["norm2"] = init_norm(cfg, cfg.d_model, dev, lead)
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dev, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                expert_sink=None) -> Dict:
    """Random params for a served config, made on ``device`` from a seeded
    ``torch.Generator``: same tree, shapes, dtypes and scales as the JAX
    ``init_params`` (norm scales, the MoE router and the SSM's A_log, D,
    dt_bias and norm_scale float32, weights in cfg.dtype). MoE expert
    stacks are drawn one (layer, expert) slice at a time; with
    ``expert_sink(seg, name, l, e, w)`` each slice goes there instead and
    the stack is a placeholder
    (``sparsity.sparse_linear.init_stacked_serving``). A vision-stub
    config (pixtral) also has ``patch_proj`` (d, d) in cfg.dtype, drawn
    last. On the meta device: the tree, shapes and dtypes only, allocating
    nothing."""
    dev = resolve_device(device)
    segs = _check_supported(cfg)
    gen = None                 # the meta device makes shapes, no numbers
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    params = {"embed": init_embeddings(cfg, gen, dev),
              "final_norm": init_norm(cfg, cfg.d_model, dev)}
    for seg in segs:
        params[seg.name] = _init_block(cfg, gen, dev, seg, (seg.length,),
                                       expert_sink)
    if cfg.is_encdec:
        enc = encoder_layout(cfg)[0]
        params["enc_blocks"] = _init_block(cfg, gen, dev, enc, (enc.length,))
        params["enc_final_norm"] = init_norm(cfg, cfg.d_model, dev)
    if cfg.frontend == "vision_stub":
        # projection of precomputed patch embeddings into the LM stream
        params["patch_proj"] = (_normal(gen, (cfg.d_model, cfg.d_model), dev)
                                * cfg.d_model ** -0.5).to(dtype_of(cfg))
    return params


def layer_slice(tree, l: int):
    """Layer ``l`` of every leaf of a stacked nested dict (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _sinusoidal_at(positions, d: int):
    """Sinusoidal position embedding at explicit positions (B, S) -> (B, S,
    d) float32, sin on the even columns and cos on the odd: the same
    elementwise math whether S is 1 (a decode step) or a chunk, which
    keeps chunked prefill bitwise stepwise decode for archs without RoPE
    (whisper)."""
    posf = positions.float()
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = posf[..., None] / (10000.0 ** (dim / d))
    pe = torch.zeros(posf.shape + (d,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def _sinusoidal(S: int, d: int, dtype, device=None):
    """(S, d) sinusoidal position table of positions 0..S-1, in ``dtype``
    (the encoder's)."""
    return _sinusoidal_at(torch.arange(S, device=device)[None], d)[0].to(dtype)


@torch.no_grad()
def encode(params, frames, cfg: ModelConfig):
    """The whisper encoder over stub frame embeddings (B, Se, D): sinusoidal
    positions, then per layer norm, non-causal attention, norm and the
    gelu MLP, then the final norm. Unpacked, as in the reference: the
    projections are plain matmuls, the attention and norms run in the
    port's row kernels."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model, frames.dtype,
                             frames.device)
    positions = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    blocks = params["enc_blocks"]
    for l in range(blocks["norm1"]["scale"].shape[0]):
        p = layer_slice(blocks, l)
        hn = apply_norm(p["norm1"], x, cfg)
        x = x + attn_mod.attention(p["attn"], hn, cfg, positions,
                                   causal=False)
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return apply_norm(params["enc_final_norm"], x, cfg)


@torch.no_grad()
def forward(params, tokens, cfg: ModelConfig, frontend_embeds=None,
            enc_out=None, last_only: bool = False, tables=None):
    """Full-sequence forward to logits: the reference's ``forward``.

    tokens (B, S) int. frontend_embeds: pixtral's patch embeddings (B,
    n_patches, D), projected by ``patch_proj`` (a plain matmul, as in the
    reference) and prepended to the token stream; logits come for the
    token positions only. enc_out: the whisper encoder's output (B, Se,
    D) for cross-attention. last_only: unembed the last position only
    (prefill). tables (sparsity.sparse_linear.SegmentedKernelTables):
    every packed projection of every layer runs on the joint kernel, each
    segment's layers with their slices of its stacked tables; None keeps
    plain matmuls. Attention is causal over the sequence's own keys, with
    ``cfg.window`` as a lower key bound; SSM layers run ``apply_ssm``
    (S % min(cfg.ssm_chunk, S) == 0); MoE layers dispatch the whole
    sequence at once, as the reference's forward does. Returns (B, S, V)
    logits, or (B, 1, V) with ``last_only``."""
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg)
    n_front = 0
    if cfg.frontend == "vision_stub" and frontend_embeds is not None:
        fe = torch.matmul(frontend_embeds, params["patch_proj"])
        x = torch.cat([fe.to(x.dtype), x], dim=1)
        n_front = frontend_embeds.shape[1]
    if cfg.rope_pct == 0:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device).expand(B, -1)
    segs = _check_supported(cfg)
    seg_tables = segment_tables(tables, segs, cfg)
    for seg in segs:
        st = seg_tables.get(seg.name)
        for l in range(seg.length):
            p = layer_slice(params[seg.name], l)
            mm = (st.dense_fn(layer_slice(st.arrays, l))
                  if st is not None else None)
            hn = apply_norm(p["norm1"], x, cfg)
            if seg.mixer == "attn":
                x = x + attn_mod.attention(p["attn"], hn, cfg, positions,
                                           dense_fn=mm)
            else:
                x = x + ssm_mod.apply_ssm(p["ssm"], hn, cfg, dense_fn=mm)
            x = _block_tail(seg, p, x, cfg, mm, enc_out)
    x = apply_norm(params["final_norm"], x, cfg)
    if n_front:
        x = x[:, n_front:]
    if last_only:
        x = x[:, -1:]
    return logits_from_hidden(params["embed"], x, cfg)


def _block_tail(seg: Segment, p, h, cfg: ModelConfig, mm=None,
                enc_out=None, per_position: bool = False):
    """The sublayers after the mixer: cross-attention over ``enc_out``
    (the whisper decoder), then the MLP, the MoE (with arctic's dense
    residual MLP; ``per_position`` groups its capacity dispatch by chunk
    position, so each position's pool is one decode step's), or nothing
    for a segment with no FFN (mamba2)."""
    if seg.cross:
        hx = apply_norm(p["norm_x"], h, cfg)
        h = h + attn_mod.cross_attention(p["xattn"], hx, enc_out, cfg,
                                         dense_fn=mm)
    if seg.ffn == "moe":
        y, _aux = moe_mod.apply_moe_block(
            p["moe"], apply_norm(p["norm2"], h, cfg), cfg, dense_fn=mm,
            per_position=per_position)
        h = h + y
    elif seg.ffn == "mlp":
        h = h + apply_mlp(p["mlp"], apply_norm(p["norm2"], h, cfg), cfg,
                          dense_fn=mm)
    return h


def segment_tables(tables, segs, cfg: ModelConfig):
    """Per-segment table lookup for a segment layout. {} for dense
    serving; raises when the tables were packed for another layout."""
    if tables is None:
        return {}
    seg_map = getattr(tables, "segments", None)
    if seg_map is None:
        raise ValueError("stacked tables must be a segmented pack "
                         "(sparsity.sparse_linear.build_stacked_tables)")
    missing = [s.name for s in segs if s.name not in seg_map]
    if missing:
        raise ValueError(f"stacked tables do not match {cfg.name}'s "
                         f"segment layout: missing segments {missing} "
                         f"(packed: {sorted(seg_map)})")
    return seg_map
