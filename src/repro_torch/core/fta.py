"""Fixed-Threshold Approximation (FTA) — Alg. 1 of the paper, on torch.

Per filter (output channel, the last axis):
  1. phi(w) = CSD non-zero digit count of each INT8-quantized weight.
  2. m = mode of phi over *unmasked* weights (ties toward the smaller
     count).
  3. Threshold: all-zero filter -> 0; m == 0 -> 1; 1 <= m <= 2 -> m;
     m > 2 -> 2.
  4. Re-project every unmasked weight to the nearest value with exactly
     phi_th CSD digits (ties toward the larger value, ``PROJECTION_LUT``).
     Masked weights stay 0.

Both steps are integer table lookups and integer counts, so the result is
the same on every device and equal to the JAX package's numpy pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .csd import INT8_MAX, INT8_MIN, PHI_TABLE

MAX_PHI_TH = 2
DOMAIN = np.arange(INT8_MIN, INT8_MAX + 1, dtype=np.int32)


def threshold_table(phi_th: int) -> np.ndarray:
    """T(phi_th): all INT8 values with exactly phi_th non-zero CSD digits."""
    return DOMAIN[PHI_TABLE == phi_th]


def _build_projection_lut() -> np.ndarray:
    """LUT[phi_th, v+128] = nearest element of T(phi_th) to v; ties go to
    the larger value (the paper projects an unpruned 0 to +1 under
    phi_th=1). Shape (MAX_PHI_TH+1, 256), int32."""
    lut = np.zeros((MAX_PHI_TH + 1, DOMAIN.size), dtype=np.int32)
    for phi in range(MAX_PHI_TH + 1):
        tbl = threshold_table(phi)
        dist = np.abs(DOMAIN[None, :] - tbl[:, None])        # (|T|, 256)
        idx = dist.shape[0] - 1 - np.argmin(dist[::-1], axis=0)
        lut[phi] = tbl[idx]
    return lut


PROJECTION_LUT = _build_projection_lut()


def compute_thresholds(q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """phi_th per filter. ``q`` int (..., K, N), filters on the last axis;
    ``mask`` same shape, 1 = kept. Returns int32 (..., N)."""
    q = q.to(torch.int64)
    m = mask.to(torch.int64)
    phi_tab = torch.as_tensor(PHI_TABLE, device=q.device).to(torch.int64)
    phi = phi_tab[q - INT8_MIN] * m                          # masked -> 0
    kept = m == 1
    counts = torch.stack([((phi == c) & kept).sum(dim=-2)
                          for c in range(9)])                # (9, ..., N)
    mode = torch.argmax(counts, dim=0)                       # ties -> smaller
    any_unmasked = m.sum(dim=-2) > 0
    all_zero = (q.abs() * m).sum(dim=-2) == 0
    th = torch.where(mode == 0, torch.ones_like(mode),
                     torch.clamp(mode, max=MAX_PHI_TH))
    th = torch.where(all_zero | ~any_unmasked, torch.zeros_like(th), th)
    return th.to(torch.int32)


def project(q: torch.Tensor, mask: torch.Tensor,
            phi_th: torch.Tensor) -> torch.Tensor:
    """Nearest-in-T(phi_th) projection; masked weights forced to 0.
    q int (..., K, N); phi_th int (..., N) broadcast over K. int32 out."""
    q = q.to(torch.int64)
    lut = torch.as_tensor(PROJECTION_LUT, device=q.device).to(torch.int64)
    th = phi_th.to(torch.int64).unsqueeze(-2).expand(q.shape)
    proj = lut[th, q - INT8_MIN]
    return (proj * mask.to(torch.int64)).to(torch.int32)


def fta_quantize(q: torch.Tensor, mask: torch.Tensor):
    """Full Alg. 1: thresholds + projection. Returns (w_fta, phi_th)."""
    th = compute_thresholds(q, mask)
    return project(q, mask, th), th


def achieved_bit_sparsity(w_fta: torch.Tensor, mask=None) -> float:
    """Fraction of zero CSD digits among stored (unmasked) weights: the
    paper's bit-level sparsity (>= 75 % when phi_th <= 2)."""
    w = torch.as_tensor(w_fta).to(torch.int64)
    phi = torch.as_tensor(PHI_TABLE, device=w.device).to(torch.int64)[
        w - INT8_MIN]
    if mask is not None:
        phi = phi[torch.as_tensor(mask, device=w.device) == 1]
    if phi.numel() == 0:
        return 1.0
    return float(1.0 - int(phi.sum()) / (8.0 * phi.numel()))
