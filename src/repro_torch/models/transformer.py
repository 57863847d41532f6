"""Parameter construction, the whisper encoder and the shared block tail.

Port of ``repro.models.transformer`` for serving: every decoder the
segment layout describes (``models.segments``): dense-attention stacks
(full causal or sliding-window attention), attention + MoE stacks
(mixtral, arctic), attention-free SSM stacks (mamba2), hybrid stacks of
interleaved SSM, attention, MLP and MoE layers (jamba), and the whisper
decoder with cross-attention, beside its encoder (``encode``). Layer
stacks are parameter-stacked with a leading layer axis, as in the JAX
package; the decode loops in ``models.decode`` walk them layer by layer
where JAX scans. Params come from a ``torch.Generator`` on the device,
with the JAX package's shapes and scales (its numbers differ: the tests
feed JAX-initialised params through ``repro_torch.weights`` instead).
The full-sequence forward (``forward``, training) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_embeddings, init_mlp, init_norm
from .segments import Segment, decoder_layout, encoder_layout


def _check_supported(cfg: ModelConfig):
    """The decoder's segments; raises for the one frontend the port does
    not serve (every mixer / FFN / cross-attention composition of the
    segment layout is served)."""
    if cfg.frontend == "vision_stub":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the vision frontend (pixtral) "
            f"enters only through the full-sequence forward, which is not "
            f"ported yet (ROADMAP Queue 1 item 4b and the pixtral stub)")
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
    (``sparsity.sparse_linear.init_stacked_serving``). On the meta device:
    the tree, shapes and dtypes only, allocating nothing."""
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
