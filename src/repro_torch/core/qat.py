"""INT8 quantization used by the DB-PIM weight compilation.

Port of the quantization step of ``repro.core.qat``: ``quantize_int8``,
which ``kernels.ops.fta_pack`` uses. The QAT pieces (EMA range observer,
straight-through fake-quant, FTA-aware export) come with the training
slice.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric INT8: round(x / scale) (half to even, as ``jnp.round``),
    clipped to [-127, 127], int32. ``scale`` is a float32 scalar tensor or
    a number; the division runs in x's dtype."""
    q = torch.round(x / scale)
    return torch.clamp(q, -127, 127).to(torch.int32)
