"""Kernel launches read from the device's own records.

A kernel wrapper counts its launches on the host (``LAUNCHES``), and the
replays of a CUDA graph launch kernels the host never sees.
``device_launches`` counts them from torch.profiler's device-side records
instead, by each wrapper's kernel ``SYMBOLS``, so launches inside graph
replays are measured, not inferred from the capture.
"""

from __future__ import annotations

import re


def device_launches(events, modules) -> dict:
    """{name: launches} for each kernel wrapper module of ``modules``
    ({name: module}) among ``events`` (torch.profiler's
    ``key_averages()``): the device-side records whose kernel name holds
    one of the module's ``SYMBOLS`` as a whole identifier. Wrappers that
    share a kernel source (the joint and block-sparse matmuls) share
    symbols and cannot be told apart here."""
    from torch.autograd import DeviceType
    patterns = {
        name: re.compile(r"(?<!\w)(?:" + "|".join(map(re.escape, mod.SYMBOLS))
                         + r")(?!\w)")
        for name, mod in modules.items()}
    out = dict.fromkeys(modules, 0)
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        for name, pattern in patterns.items():
            if pattern.search(e.key):
                out[name] += e.count
    return out
