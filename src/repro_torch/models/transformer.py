"""Parameter construction and the shared block tail for decoder LMs.

Port of the decoder part of ``repro.models.transformer``: dense-attention
stacks (full causal or sliding-window attention), attention + MoE stacks
(mixtral, arctic) and attention-free SSM (mamba2) stacks. Layer stacks are
parameter-stacked with a leading layer axis, as in the JAX package; the
decode loops in ``models.decode`` walk them layer by layer where JAX
scans. Params come from a ``torch.Generator`` on the device, with the JAX
package's shapes and scales (its numbers differ: the tests feed
JAX-initialised params through ``repro_torch.weights`` instead).
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
from .segments import Segment, decoder_layout


#: the (mixer, ffn) layer kinds the port serves: attention + gated MLP
#: (dense family), attention + MoE (mixtral, arctic) and SSM with no FFN
#: (mamba2)
_LAYER_KINDS = {("attn", "mlp"), ("attn", "moe"), ("ssm", "none")}


def _check_supported(cfg: ModelConfig):
    segs = decoder_layout(cfg)
    ok = (cfg.frontend == "none" and not cfg.is_encdec
          and all((s.mixer, s.ffn) in _LAYER_KINDS and not s.cross
                  for s in segs)
          and (cfg.mlp_type in ("swiglu", "geglu")
               or all(s.ffn == "none" for s in segs)))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port serves attention stacks "
            f"(full causal or sliding-window) with gated MLP or MoE FFNs, "
            f"and SSM (mamba2) stacks, so far (hybrid stacks, enc-dec "
            f"cross-attention and frontends are later slices)")
    return segs


def _init_block(cfg: ModelConfig, gen, dev, seg: Segment, lead,
                expert_sink=None):
    """One segment's stacked layers: norm + mixer, then the FFN if the
    segment has one (the JAX ``_init_block``). ``expert_sink`` takes the
    MoE expert slices as they are drawn (``moe.init_moe``)."""
    p = {"norm1": init_norm(cfg, cfg.d_model, dev, lead)}
    if seg.mixer == "attn":
        p["attn"] = attn_mod.init_attention(cfg, gen, dev, lead)
    else:
        p["ssm"] = ssm_mod.init_ssm(cfg, gen, dev, lead)
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
    return params


def layer_slice(tree, l: int):
    """Layer ``l`` of every leaf of a stacked nested dict (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _block_tail(seg: Segment, p, h, cfg: ModelConfig, mm=None,
                per_position: bool = False):
    """The sublayers after the mixer: the MLP, the MoE (with arctic's
    dense residual MLP; ``per_position`` groups its capacity dispatch by
    chunk position, so each position's pool is one decode step's), or
    nothing for a segment with no FFN (SSM stacks). Cross-attention waits
    for its slice; _check_supported refuses it."""
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
