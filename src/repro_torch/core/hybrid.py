"""Hybrid-grained pruning pipeline (Fig. 4): the paper's three stages as
a reusable driver over dicts of weight matrices.

Port of ``repro.core.hybrid``, over the port's ``core.pruning``, ``qat``,
``fta`` and ``dyadic``:

  stage 1  coarse-grained block-wise pruning  -> masks
  stage 2  FTA-aware QAT                      -> EMA scales + projected weights
  stage 3  final FTA quantization             -> FTAExport (q, scale, phi_th,
                                                 mask) + packed DB metadata

The driver is model-agnostic: it takes a dict of 2-D weight matrices (K,
N); callers flatten conv kernels im2col-style (Kh*Kw*Cin, Cout) and pass
LM projections as (d_in, d_out). Masks, ``q``, ``phi_th`` and the packed
terms are integer tables, the same on every device and equal to the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import dyadic, fta, pruning, qat


@dataclass(frozen=True)
class HybridConfig:
    value_sparsity: float = 0.6        # coarse block-prune ratio
    alpha: int = pruning.DEFAULT_ALPHA
    ema_decay: float = 0.99
    # Layers can opt out (paper: dw-conv / routers are left dense).
    exclude: tuple = ()


def prune_tree(weights: Dict[str, torch.Tensor], cfg: HybridConfig):
    """Stage 1: masks (int32) for every eligible tensor; the others (in
    ``exclude``, not 2-D, or N not a multiple of alpha) all ones."""
    masks = {}
    for name, w in weights.items():
        if name in cfg.exclude or w.ndim != 2 or w.shape[-1] % cfg.alpha:
            masks[name] = torch.ones(w.shape, dtype=torch.int32,
                                     device=w.device)
        else:
            masks[name] = pruning.block_prune_mask(
                w.detach(), cfg.value_sparsity, cfg.alpha)
    return masks


def qat_step(weights, masks, ema_states, cfg: HybridConfig):
    """Stage 2 inner step: update the EMA ranges and return the
    FTA-projected fake-quant weights (STE) for the forward pass, the new
    EMA states and the thresholds (None for an excluded tensor, which
    passes through)."""
    new_states, w_fq, phi = {}, {}, {}
    for name, w in weights.items():
        st = ema_states.get(name) or qat.ema_init(w.device)
        st = qat.ema_update(st, w)
        new_states[name] = st
        if name in cfg.exclude:
            w_fq[name] = w
            phi[name] = None
            continue
        scale = qat.scale_of(st)
        w_fq[name], phi[name] = qat.fta_fake_quant(w, masks[name], scale)
    return w_fq, new_states, phi


def export_tree(weights, masks, ema_states, cfg: HybridConfig):
    """Stage 3: final FTA quantization and DB metadata packing per
    tensor: {name: {"export": FTAExport, "packed_terms": uint8 (K, N,
    max_terms)}}."""
    out = {}
    for name, w in weights.items():
        if name in cfg.exclude:
            continue
        scale = qat.scale_of(ema_states[name])
        exp = qat.fta_export(w, masks[name], scale)
        out[name] = {"export": exp, "packed_terms": dyadic.pack_terms(exp.q)}
    return out


def sparsity_report(exports) -> Dict[str, dict]:
    """Per-tensor compound sparsity stats (feeds the PIM cost model):
    value, bit and compound sparsity and the phi_th histogram."""
    rep = {}
    for name, e in exports.items():
        exp = e["export"]
        v_s = pruning.value_sparsity(exp.mask.cpu())
        b_s = fta.achieved_bit_sparsity(exp.q.cpu(), exp.mask.cpu())
        rep[name] = {
            "value_sparsity": v_s,
            "bit_sparsity": b_s,
            "compound_sparsity": 1 - (1 - v_s) * (1 - b_s),
            "phi_th_hist": np.bincount(exp.phi_th.cpu().numpy(),
                                       minlength=3).tolist(),
        }
    return rep
