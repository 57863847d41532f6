"""Parameter construction and the shared block tail for decoder LMs.

Port of the dense-family part of ``repro.models.transformer``. Layer
stacks are parameter-stacked with a leading layer axis, as in the JAX
package; the decode loops in ``models.decode`` walk them layer by layer
where JAX scans. Params come from a ``torch.Generator`` on the device, with
the JAX package's shapes and scales (its numbers differ: the tests feed
JAX-initialised params through ``repro_torch.weights`` instead).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from . import attention as attn_mod
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_embeddings, init_mlp, init_norm
from .segments import Segment, decoder_layout


def _check_supported(cfg: ModelConfig):
    segs = decoder_layout(cfg)
    ok = (cfg.frontend == "none" and not cfg.is_encdec and not cfg.window
          and cfg.mlp_type in ("swiglu", "geglu")
          and all(s.mixer == "attn" and s.ffn == "mlp" and not s.cross
                  for s in segs))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port serves the dense-attention "
            f"family with full causal attention and gated MLPs so far (SSM, "
            f"MoE, hybrid, enc-dec and sliding windows are later slices)")
    return segs


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random params for a dense-family config, made on ``device`` from a
    seeded ``torch.Generator``: same tree, shapes, dtypes and scales as
    the JAX ``init_params`` (norm scales float32, weights in cfg.dtype)."""
    dev = resolve_device(device)
    segs = _check_supported(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"embed": init_embeddings(cfg, gen, dev),
              "final_norm": init_norm(cfg, cfg.d_model, dev)}
    for seg in segs:
        lead = (seg.length,)
        params[seg.name] = {
            "norm1": init_norm(cfg, cfg.d_model, dev, lead),
            "attn": attn_mod.init_attention(cfg, gen, dev, lead),
            "norm2": init_norm(cfg, cfg.d_model, dev, lead),
            "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dev, lead)}
    return params


def layer_slice(tree, l: int):
    """Layer ``l`` of every leaf of a stacked nested dict (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _block_tail(seg: Segment, p, h, cfg: ModelConfig, mm=None):
    """The sublayers after the mixer: the MLP (cross-attention and MoE
    wait for their slices; _check_supported refuses them)."""
    return h + apply_mlp(p["mlp"], apply_norm(p["norm2"], h, cfg), cfg,
                         dense_fn=mm)


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
