"""Row-stable RMSNorm / LayerNorm over the last axis.

The reference computes its norms with plain jnp (``repro.models.layers
.apply_norm`` and ``rms_head_norm``); no Pallas kernel replaces them. The
port runs them in a hand-written kernel so that a row's output does not
depend on how many rows share the call: torch's mean picks its summation
order from the whole shape, so a 1-token decode and a C-token prefill chunk
would part in the last bits on the card.

Three things live here:

  * ``row_norm`` — the wrapper. A CPU tensor takes the plain version; a
    CUDA tensor launches the hand-written kernel (``csrc/row_norm.cu``,
    built by ``nvcc`` for sm_90a on first use, loaded with ctypes) or
    raises. There is no fallback. Up to 256 threads share a row and hold
    it in registers (16-byte loads), so x is read once; the summation
    order is fixed over element indices by D alone.
  * ``row_norm_plain`` — the reference's math in plain PyTorch.
  * ``LAUNCHES`` — the number of kernel launches so far, raised by one at
    each launch and nowhere else. A launch recorded into a CUDA graph
    runs at the graph's replays, which the host does not see: its capture
    counts nothing, and the launches inside replays are read from the
    device's own records (torch.profiler) by ``SYMBOLS``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.runtime import op_cost
from . import build

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

#: the CUDA kernel symbols a launch runs, as the profiler names them
SYMBOLS = ("row_norm_kernel",)

#: the longest row the kernel takes (``row_norm.cu``: 256 threads x 128)
MAX_D = 32768

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def row_norm_plain(x, scale, bias=None, eps: float = 1e-6,
                   plus_one: bool = False):
    """LayerNorm when ``bias`` is given, else RMSNorm (scaled by
    ``1 + scale`` with ``plus_one``); fp32 math, x's dtype out."""
    xf = x.float()
    if bias is not None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        s = (1.0 + scale) if plus_one else scale
        out = xf * torch.rsqrt(var + eps) * s
    return out.to(x.dtype)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("row_norm")
        fn = lib.row_norm_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _param(t, D, device, name):
    if t.shape != (D,) or t.device != device:
        raise ValueError(f"{name} must be ({D},) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _check(x, D):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if D > MAX_D:
        raise ValueError(f"row length {D} > {MAX_D}: 256 threads of 16 "
                         f"chunks of 8 hold a row")


def _report(x, layer: bool, plus_one: bool):
    """The call as ``runtime.op_cost`` charges it: the reference's norm ops
    are elementwise and reductions, flops only (RMSNorm: square, scale and
    weight per element, mean, eps and rsqrt per row; LayerNorm: centre,
    square, scale, weight and bias per element, two means, eps and rsqrt
    per row), no bytes and no weight bytes."""
    D = x.shape[-1]
    n = x.numel()
    rows = n // D if D else 0
    flops = (5 * n + 6 * rows if layer
             else 3 * n + 4 * rows + (D if plus_one else 0))
    op_cost.charge_ops(flops=flops)
    return torch.empty_like(x)


def row_norm(x, scale, bias=None, eps: float = 1e-6, plus_one: bool = False):
    """The norm of ``row_norm_plain`` over x's last axis. CPU tensors run
    the plain version; CUDA tensors launch the kernel on the current
    stream or raise."""
    global LAUNCHES
    if op_cost.recording(x, scale, bias):
        return _report(x, bias is not None, plus_one)
    if x.device.type == "cpu":
        return row_norm_plain(x, scale, bias, eps, plus_one)
    if x.device.type != "cuda":
        raise ValueError(f"row_norm runs on cuda or cpu, not {x.device}")
    D = x.shape[-1]
    _check(x, D)
    scale = _param(scale, D, x.device, "scale")
    if bias is not None:
        bias = _param(bias, D, x.device, "bias")
    x = x.contiguous()
    out = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.row_norm_launch(
            x.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), R, D,
            eps, int(plus_one and bias is None), _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"row_norm launch failed: CUDA error {rc} (R={R}, "
                           f"D={D})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return out
