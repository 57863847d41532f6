"""Row-stable RMSNorm / LayerNorm over the last axis.

The reference computes its norms with plain jnp (``repro.models.layers
.apply_norm`` and ``rms_head_norm``); no Pallas kernel replaces them. The
port runs them in a hand-written kernel so that a row's output does not
depend on how many rows share the call: torch's mean picks its summation
order from the whole shape, so a 1-token decode and a C-token prefill chunk
would part in the last bits on the card.

What lives here:

  * ``row_norm`` — the wrapper. A CPU tensor takes the plain version,
    which autograd differentiates; a CUDA tensor launches the hand-written
    kernel (``csrc/row_norm.cu``, built by ``nvcc`` for sm_90a on first
    use, loaded with ctypes) or raises. There is no fallback. Up to 256
    threads share a row and hold it in registers (16-byte loads), so x is
    read once; the summation order is fixed over element indices by D
    alone. When autograd records (grad mode on and x, scale or bias
    requiring grad), the CUDA call runs through ``RowNorm``, a
    ``torch.autograd.Function`` whose backward is ``row_norm_backward``.
  * ``row_norm_backward`` — the backward kernels: dx per row in fp32 (cast
    to x's dtype), with ``tpr`` threads a row from D alone (``bwd_plan``:
    at most 4 chunks of 8 a thread; shuffles inside a warp, and a named
    barrier of the row's own warps past it), one pass giving all of a
    row's sums at once, so a row's dx does not depend on R; a block of 256
    threads holds 256 / tpr rows, so that 1,024 rows of 2,048 are all in
    flight at once. dscale (dbias) are summed over rows without float
    atomics: each block adds its rows' sums in a fixed order into one
    partial row, and a second kernel adds the blocks' partials over many
    warps in fixed runs, combined in warp order, so the gradients come out
    bitwise the same from run to run. The two kernels write every element
    of dx, dscale and dbias: nothing is zero-filled. Bound: bytes, x and
    dy read once and dx written once (3.76 µs a launch at 1,024 x 2,048
    bf16, 3.35 TB/s). Rows up to ``BWD_MAX_D``; a longer one raises.
  * ``row_norm_plain`` — the reference's math in plain PyTorch, and
    ``row_norm_backward_plain`` — its autograd gradient, the backward
    kernels' plain version (tests and ``chip_smoke.py`` compare with it;
    the card's training path never takes it).
  * ``LAUNCHES`` and ``BWD_LAUNCHES`` — the forward's and the backward's
    launches so far, each raised by one at its launch and nowhere else. A
    launch recorded into a CUDA graph runs at the graph's replays, which
    the host does not see: its capture counts nothing, and the launches
    inside replays are read from the device's own records
    (torch.profiler) by ``SYMBOLS``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.runtime import op_cost
from . import build

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0
#: backward launches so far (``row_norm_backward``'s CUDA branch only):
#: one a call, which runs the row kernel and the parameter sums
BWD_LAUNCHES = 0

#: the CUDA kernel symbols the launches run, as the profiler names them:
#: the forward's, then the backward's row kernel and parameter sums, which
#: only a training step launches
SYMBOLS = ("row_norm_kernel", "row_norm_bwd_kernel",
           "row_norm_param_sum_kernel")

#: the longest row the kernel takes (``row_norm.cu``: 256 threads x 128)
MAX_D = 32768
#: the longest row the backward takes (256 threads x 4 chunks of 8)
BWD_MAX_D = 8192
#: the backward's blocks: threads, chunks a thread at most, the grid's cap
#: (2 blocks on each of the H100's 132 SMs) (``row_norm.cu``)
BWD_BLOCK, BWD_CPT, BWD_MAX_BLOCKS = 256, 4, 264

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


def row_norm_backward_plain(dy, x, scale, bias=None, eps: float = 1e-6,
                            plus_one: bool = False):
    """(dx, dscale, dbias) of ``row_norm_plain`` for the output gradient
    ``dy``, by autograd (dbias None for RMSNorm): the backward kernels'
    plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale)]
        if bias is not None:
            leaves.append(bias.detach().requires_grad_())
        out = row_norm_plain(leaves[0], leaves[1],
                             leaves[2] if bias is not None else None, eps,
                             plus_one)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], grads[1], grads[2] if bias is not None else None


def bwd_plan(R: int, D: int) -> dict:
    """The backward's launch shape for R rows of D, as ``row_norm.cu``'s
    ``bwd_layout`` picks it: threads a row (``tpr``, the least power of
    two holding the row at ``BWD_CPT`` chunks of 8 a thread) and chunks a
    thread (``cpt``) from D alone; rows a block (``rpb``); the row
    kernel's blocks (``blocks``, capped at ``BWD_MAX_BLOCKS``), which are
    also the partial rows of each parameter sum (``row_norm_bwd_slots``);
    and the row kernel's shared memory (``smem``: rpb rows of D rounded
    up to whole chunks, floats: the scale, then the row groups' sums).
    None past ``BWD_MAX_D``."""
    chunks = -(-D // 8)
    tpr = 1
    while tpr * BWD_CPT < chunks:
        tpr *= 2
    if tpr > BWD_BLOCK:
        return None
    rpb = BWD_BLOCK // tpr
    return dict(tpr=tpr, cpt=-(-chunks // tpr), rpb=rpb,
                blocks=min(-(-R // rpb), BWD_MAX_BLOCKS),
                smem=rpb * chunks * 8 * 4)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("row_norm")
        fn = lib.row_norm_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.row_norm_bwd_slots
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        fn = lib.row_norm_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
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


class _Recorded(torch.autograd.Function):
    """The norm as ``runtime.op_cost`` charges it when autograd records the
    call (the train step's walk): the forward ``_report``, and a backward
    that charges the reference's gradient of the norm (elementwise ops
    and reductions, about 9 flops an element for RMSNorm and 14 for
    LayerNorm, and a few a row and a column; flops only) and returns
    empty gradients of each input's shape and dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, plus_one):
        ctx.layer = bias is not None
        ctx.like = (x, scale, bias)
        return _report(x, ctx.layer, plus_one)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.like
        D = x.shape[-1]
        n = x.numel()
        rows = n // D if D else 0
        op_cost.charge_ops(flops=(14 * n + 6 * rows + 4 * D if ctx.layer
                                  else 9 * n + 4 * rows + 3 * D))
        return (torch.empty_like(x), torch.empty_like(scale),
                None if bias is None else torch.empty_like(bias), None)


def _launch(x, scale, bias, eps: float, plus_one: bool):
    """The forward kernel on CUDA tensors: (out, the contiguous x, the
    float32 scale and bias it read)."""
    global LAUNCHES
    D = x.shape[-1]
    _check(x, D)
    scale = _param(scale, D, x.device, "scale")
    if bias is not None:
        bias = _param(bias, D, x.device, "bias")
    x = x.contiguous()
    out = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return out, x, scale, bias
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
    return out, x, scale, bias


def row_norm_backward(dy, x, scale, bias=None, eps: float = 1e-6,
                      plus_one: bool = False):
    """(dx, dscale, dbias) of the norm for the output gradient ``dy``, on
    CUDA tensors: the backward kernels on the current stream, or raises.
    dx in x's dtype, dscale and dbias float32 (D,) (dbias None for
    RMSNorm)."""
    global BWD_LAUNCHES
    if dy.device.type != "cuda" or x.device != dy.device:
        raise ValueError(f"row_norm_backward runs on cuda, got dy on "
                         f"{dy.device}, x on {x.device}")
    D = x.shape[-1]
    _check(x, D)
    if D > BWD_MAX_D:
        raise ValueError(f"row length {D} > {BWD_MAX_D}: the backward holds "
                         f"4 chunks of 8 a thread")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    scale = _param(scale, D, x.device, "scale")
    layer = bias is not None
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        dscale = torch.zeros(D, dtype=torch.float32, device=x.device)
        return dx, dscale, torch.zeros_like(dscale) if layer else None
    # the kernels write every element: no fill launch
    dscale = torch.empty(D, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale) if layer else None
    lib = _library()
    slots = lib.row_norm_bwd_slots(R, D)
    partial = torch.empty(((2 if layer else 1) * slots, D),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.row_norm_bwd_launch(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), int(layer),
            dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
            None if dbias is None else dbias.data_ptr(), R, D, eps,
            int(plus_one and not layer), _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"row_norm backward launch failed: CUDA error {rc} "
                           f"(R={R}, D={D})")
    if not torch.cuda.is_current_stream_capturing():
        BWD_LAUNCHES += 1
    return dx, dscale, dbias


class RowNorm(torch.autograd.Function):
    """The norm on CUDA tensors with the backward kernels as its gradient:
    x, scale and bias get gradients in their own dtypes (a float32 scale,
    as the models keep their norm scales, a float32 gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, plus_one):
        out, xc, sc, bi = _launch(x, scale, bias, eps, plus_one)
        ctx.save_for_backward(xc, sc, bi)
        ctx.eps, ctx.plus_one = eps, plus_one
        ctx.dtypes = (scale.dtype, None if bias is None else bias.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = row_norm_backward(dy, x, scale, bias, ctx.eps,
                                              ctx.plus_one)
        dscale = dscale.to(ctx.dtypes[0])
        if dbias is not None:
            dbias = dbias.to(ctx.dtypes[1])
        return dx, dscale, dbias, None, None


def row_norm(x, scale, bias=None, eps: float = 1e-6, plus_one: bool = False):
    """The norm of ``row_norm_plain`` over x's last axis. CPU tensors run
    the plain version (autograd differentiates it); CUDA tensors launch
    the kernel on the current stream or raise, through ``RowNorm`` when
    autograd records the call."""
    if op_cost.recording(x, scale, bias):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, scale, bias)):
            return _Recorded.apply(x, scale, bias, plus_one)
        return _report(x, bias is not None, plus_one)
    if x.device.type == "cpu":
        return row_norm_plain(x, scale, bias, eps, plus_one)
    if x.device.type != "cuda":
        raise ValueError(f"row_norm runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        return RowNorm.apply(x, scale, bias, eps, plus_one)
    return _launch(x, scale, bias, eps, plus_one)[0]
