"""Kernel launches read from the device's own records.

A kernel wrapper counts its launches on the host (``LAUNCHES``), and the
replays of a CUDA graph launch kernels the host never sees.
``device_launches`` counts them from torch.profiler's device-side records
instead, by each wrapper's kernel ``SYMBOLS``, so launches inside graph
replays are measured, not inferred from the capture. ``per_call`` says
how many a serving step call must make.
"""

from __future__ import annotations

import re
from collections import Counter


def device_launches(prof, modules) -> dict:
    """{name: launches} for each kernel wrapper module of ``modules``
    ({name: module}) in ``prof``, a finished ``torch.profiler.profile``:
    its device-side records whose kernel name holds one of the module's
    ``SYMBOLS`` as a whole identifier. The records are counted by name
    straight from the profiler's raw results (a mixtral-8x7b serve run
    records ~2 M kernels: ``key_averages`` builds a Python event for each,
    which takes minutes). Wrappers that share a kernel source (the joint
    and block-sparse matmuls) share symbols and cannot be told apart
    here."""
    from torch.autograd import DeviceType
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    patterns = {
        name: re.compile(r"(?<!\w)(?:" + "|".join(map(re.escape, mod.SYMBOLS))
                         + r")(?!\w)")
        for name, mod in modules.items()}
    out = dict.fromkeys(modules, 0)
    for kernel, n in names.items():
        for name, pattern in patterns.items():
            if pattern.search(kernel):
                out[name] += n
    return out


def per_call(cfg, token_steps: int = 1) -> dict:
    """{name: launches} of one serving step call of ``cfg``'s joint-mode
    path: the joint kernel once per packed projection and layer (a MoE
    expert projection once per expert: mixtral-8x7b 32 x (4 + 3 x 8) =
    896), row_attention once per attention layer, row_norm once per layer
    for norm1, once more per layer for the MLP's or MoE's norm2 or the
    SSM's gated norm, and once for the final norm. An SSM layer of an
    exact chunk walks ``token_steps`` token steps, each projecting and
    gating once."""
    from ..models.segments import packable_projections
    segs = cfg.serving_capabilities().segments

    def steps(s):
        return token_steps if s.mixer == "ssm" else 1

    def launches(name):
        return cfg.n_experts if name.startswith("moe/") else 1
    return {"joint_sparse_matmul": sum(
                sum(map(launches, packable_projections(s, cfg)))
                * s.length * steps(s) for s in segs),
            "row_attention": sum(s.length for s in segs if s.mixer == "attn"),
            "row_norm": 1 + sum(s.length * (1 + steps(s)) for s in segs)}
