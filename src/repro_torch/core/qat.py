"""FTA-aware quantization-aware training (Sec. III / IV-C-2) on torch
autograd, and the INT8 quantization of the DB-PIM weight compilation.

Port of ``repro.core.qat``:
  * dynamic min-max range tracking with EMA smoothing (no trainable
    params, no precomputed global ranges, per the paper): ``EMARange``,
    ``ema_init``, ``ema_update``, ``scale_of``;
  * symmetric INT8 quantization (``quantize_int8``, which
    ``kernels.ops.fta_pack`` also uses) and fake-quant with a
    straight-through estimator (``_ste``, ``fake_quant``);
  * the FTA projection folded into the forward pass
    (``fta_fake_quant``: weights projected to their nearest T(phi_th)
    value, the gradient the block-prune mask);
  * the final FTA quantization (``fta_export`` to true INT8 + scale +
    thresholds + mask, ``dequant``).

State is plain tensors and NamedTuples. Mixed operands promote as the
reference's ``jnp`` arrays do: a bf16 weight against a float32 scale (a
0-dim tensor, which torch would not promote by) computes in float32. A
scale divides as a tensor, which the card divides by exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fta
from .csd import INT8_MAX


class EMARange(NamedTuple):
    """EMA-smoothed dynamic range observer state."""
    amax: torch.Tensor              # float32 scalar, smoothed max |x|
    decay: float = 0.99
    initialized: torch.Tensor = torch.zeros(())   # 0. until first update


def ema_init(device=None) -> EMARange:
    return EMARange(amax=torch.ones((), device=device),
                    initialized=torch.zeros((), device=device))


@torch.no_grad()
def ema_update(state: EMARange, x: torch.Tensor) -> EMARange:
    """The range after observing ``x``: its max |x| (+1e-8) on the first
    update, then ``decay * amax + (1 - decay) * max |x|``."""
    cur = x.detach().abs().max().float() + 1e-8
    new = torch.where(state.initialized > 0,
                      state.decay * state.amax + (1 - state.decay) * cur,
                      cur)
    return EMARange(amax=new, decay=state.decay,
                    initialized=torch.ones((), device=new.device))


def scale_of(state: EMARange) -> torch.Tensor:
    return state.amax / torch.tensor(float(INT8_MAX), dtype=torch.float32,
                                     device=state.amax.device)


def _ste(x_fq: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward = x_fq, backward = identity
    (the reference's ``x + stop_gradient(x_fq - x)``, to the bit)."""
    return x + (x_fq - x).detach()


def _promoted(x, scale):
    """The dtype of a ``jnp`` op between x and scale (a float32 tensor of
    any rank promotes a bf16 x; a Python number does not)."""
    if isinstance(scale, torch.Tensor):
        return torch.promote_types(x.dtype, scale.dtype)
    return x.dtype


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric INT8: round(x / scale) (half to even, as ``jnp.round``),
    clipped to [-127, 127], int32. ``scale`` is a float32 scalar tensor or
    a number; the division runs in the dtype ``jnp`` would give (x's for
    a number)."""
    q = torch.round(x.to(_promoted(x, scale)) / scale)
    return torch.clamp(q, -127, 127).to(torch.int32)


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Plain symmetric INT8 fake-quant with STE (inputs / activations)."""
    q = quantize_int8(x, scale).to(x.dtype).to(_promoted(x, scale))
    return _ste(q * scale, x)


def fta_fake_quant(w: torch.Tensor, mask: torch.Tensor, scale):
    """FTA-aware weight fake-quant (the per-epoch projection of Fig. 4).

    w: float (K, N) [filters last]; mask: block-prune mask. Returns (w_fq
    with STE, phi_th (N,) int32): w_fq's values lie exactly on the scale *
    T(phi_th) grid, so the final FTA quantization is lossless, and its
    gradient is the mask's (``w*m + (w_fq*m - w*m).detach()``)."""
    q = quantize_int8(w.detach(), scale)
    q_fta, phi_th = fta.fta_quantize(q, mask)
    w_fq = q_fta.to(w.dtype).to(_promoted(w, scale)) * scale
    m = mask.to(w.dtype)
    return _ste(w_fq * m, w * m), phi_th


class FTAExport(NamedTuple):
    """Final FTA quantization artifact (Sec. IV-C-3) for one weight tensor."""
    q: torch.Tensor        # int32 (K, N) FTA-compliant INT8 values
    scale: torch.Tensor    # scalar dequant scale
    phi_th: torch.Tensor   # (N,) per-filter thresholds
    mask: torch.Tensor     # (K, N) coarse block-prune mask


@torch.no_grad()
def fta_export(w: torch.Tensor, mask: torch.Tensor, scale) -> FTAExport:
    q = quantize_int8(w, scale)
    q_fta, phi_th = fta.fta_quantize(q, mask)
    return FTAExport(q=q_fta, scale=scale, phi_th=phi_th,
                     mask=mask.to(torch.int32))


def dequant(exp: FTAExport) -> torch.Tensor:
    return exp.q.float() * exp.scale
