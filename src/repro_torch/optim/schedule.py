"""LR schedules. The paper's training protocol (Sec. VI-A): cosine
annealing 1e-3 -> 1e-7 with warmup (1e-5 start) and cooldown.

Port of ``repro.optim.schedule``. Every operation runs in float32, as the
reference's ``jnp`` does (the step, pi, the cosine and the constants each
rounded to float32): Python floats would differ in the last bits.
"""

from __future__ import annotations

import math

import torch


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def cosine_with_warmup(step, *, base_lr: float = 1e-3,
                       min_lr: float = 1e-7, warmup_start: float = 1e-5,
                       warmup_steps: int = 100, total_steps: int = 10000):
    """The learning rate at ``step`` (an int or a tensor), a float32
    scalar tensor on the step's device (the CPU for an int)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = _f32(warmup_start, dev) + _f32(base_lr - warmup_start, dev) * (
        step / _f32(max(warmup_steps, 1), dev))
    t = torch.clamp((step - _f32(warmup_steps, dev))
                    / _f32(max(total_steps - warmup_steps, 1), dev), 0.0, 1.0)
    cos = _f32(min_lr, dev) + _f32(0.5 * (base_lr - min_lr), dev) * (
        1 + torch.cos(_f32(math.pi, dev) * t))
    return torch.where(step < warmup_steps, warm, cos)
