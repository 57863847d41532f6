"""Row-stable masked GQA attention against a contiguous KV cache.

The reference computes attention with plain jnp einsums
(``repro.models.attention._sdpa``); no Pallas kernel replaces them. The
port runs it in a hand-written kernel so that a query's output does not
depend on how many queries share the call: a 1-token decode and a C-token
prefill chunk then agree bit for bit, the invariant chunked prefill rests
on. A batched matmul and torch's softmax pick their summation order from
the whole shape, so the plain version does not keep it on the card.

  q      : (B, Sq, Hq, hd)   queries, f32 or bf16
  k, v   : (B, A, Hkv, hd)   the cache, in q's dtype; Hq % Hkv == 0
  qpos   : (B, Sq) int       each query's position: keys 0..qpos are live
  window : int >= 0          a sliding window: keys at or below qpos -
                             window are dead too (0: no lower bound), the
                             reference's ``kpos > qpos - window``

What lives here:

  * ``row_attention`` — the wrapper. A CPU tensor takes the plain version,
    which autograd differentiates; a CUDA tensor launches the hand-written
    kernel
    (``csrc/row_attention.cu``, built by ``nvcc`` for sm_90a on first use,
    loaded with ctypes) or raises. There is no fallback. bf16 runs both
    products on the tensor cores (``mma.sync``): a block is one 16-row tile
    of (query, head) pairs of one KV head's group, so a K/V tile serves
    every head of the group; its four warps split each 64-key tile, and
    long caches split their keys over a thread-block cluster whose size
    comes from the cache length alone. f32 runs exact fp32 on the CUDA
    cores. A cache whose logits do not fit a block's shared memory takes a
    streaming path that recomputes them in each pass, with the same sums
    in the same orders. Every launch-shape choice depends on (A, hd,
    Hq / Hkv, dtype) only, never on Sq, B or the positions. When autograd
    records (grad mode on and q, k or v requiring grad), the CUDA call
    runs through ``RowAttention``, a ``torch.autograd.Function`` whose
    backward is ``row_attention_backward``.
  * ``row_attention_backward`` — the two backward kernels, no float
    atomics, the forward's live-key rule, the same bits from run to run:
    (a) per 16-row tile of (query, head) pairs, laid out as the forward's,
    the rows' logsumexp, D = dO . O and dQ; (b) per 16 keys of a (batch,
    KV head) dK and dV over the row tiles and the group's heads in a fixed
    order. bf16 runs every product on the tensor cores (``mma.sync``): K
    and V tiles (a), Q and dO tiles (b) staged in shared memory through
    ``cp.async`` rings, fp32 accumulators, the warps' partials added in
    warp order; f32 keeps exact fp32 on the CUDA cores. Any cache length
    (they keep no logits), head dims up to 256 (``bwd_plan``).
  * ``row_attention_plain`` — the reference's math in plain PyTorch: KV
    heads repeated, einsum logits in the activations' dtype, -1e30 mask,
    fp32 softmax cast back, einsum with v; and
    ``row_attention_backward_plain`` — its autograd gradient, the backward
    kernels' plain version (tests and ``chip_smoke.py`` compare with it;
    the card's training path never takes it).
  * ``LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` — the forward's and
    the two backward kernels' launches so far, each raised by one at its
    launch and nowhere else. A launch recorded into a CUDA graph runs at
    the graph's replays, which the host does not see: its capture counts
    nothing, and the launches inside replays are read from the device's
    own records (torch.profiler) by ``SYMBOLS``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.runtime import op_cost
from . import build

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0
#: backward launches so far: kernel (a), dQ, and kernel (b), dK and dV
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

#: the CUDA kernel symbols the launches run, as the profiler names them:
#: the forward's four, then the backward's (a) and (b), bf16 and f32, which
#: only a training step launches
SYMBOLS = ("attention_tc_kernel", "attention_stream_kernel",
           "attention_f32_kernel", "attention_f32_stream_kernel",
           "attention_bwd_dq_tc_kernel", "attention_bwd_dkv_tc_kernel",
           "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def row_attention_plain(q, k, v, qpos, window: int = 0):
    """(B, Sq, Hq, hd) attention output in q's dtype, in plain PyTorch."""
    _check_window(window)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    A = k.shape[1]
    kpos = torch.arange(A, device=q.device)[None, None, :]
    live = kpos <= qpos[:, :, None]
    if window:
        live &= kpos > qpos[:, :, None] - window
    mask = live[:, None]                                          # (B,1,Sq,A)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.transpose(1, 2))
    return out.transpose(1, 2)


def row_attention_backward_plain(dout, q, k, v, qpos, window: int = 0):
    """(dq, dk, dv) of ``row_attention_plain`` for the output gradient
    ``dout``, by autograd: the backward kernels' plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = row_attention_plain(*leaves, qpos, window)
        return torch.autograd.grad(out, leaves, dout)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("row_attention")
        fn = lib.row_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("row_attention_bwd_dq_launch",
                     "row_attention_bwd_dkv_launch"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                           + [ctypes.c_longlong] * 2
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _cache_view(t):
    """t itself when each batch row of (B, A, Hkv, hd) is contiguous (the
    kernel takes any batch stride), else a contiguous copy."""
    B, A, H, hd = t.shape
    return t if t.stride()[1:] == (H * hd, hd, 1) else t.contiguous()


#: a block's shared memory on the H100 (bytes)
_SMEM_MAX = 232448


def _plan_bytes(A: int, hd: int, dtype, stream: bool) -> int:
    if dtype == torch.float32:
        return 4 * ((128 if stream else A) + 4 * hd) + 16
    hdp = _pad_hd(hd)
    tiles = -(-A // 64)
    splits = 1                          # at least 8 key tiles per rank
    while 2 * splits <= 8 and 16 * splits <= tiles:
        splits *= 2
    per_rank = -(-tiles // splits) * 64
    q, park = 16 * (hdp + 8) * 2, 16 * hdp * 4 if splits > 1 else 0
    outs = 4 * 16 * hdp * 4
    if stream:
        return q + park + max(4 * 64 * (hdp + 8) * 2, outs) + 10 * 16 * 4
    return (max(q, park) + max(2 * 64 * (hdp + 8) * 2 + 16 * (per_rank + 8) * 4,
                               outs) + 10 * 16 * 4)


def streams(A: int, hd: int, dtype) -> bool:
    """Whether a cache of A rows at head dim hd takes the kernel's
    streaming path: its logits (bf16: 16 rows over a cluster rank's keys;
    f32: all A) do not fit a block's shared memory, so each pass recomputes
    them (``plan`` and ``f32_streams`` in ``csrc/row_attention.cu``)."""
    return _plan_bytes(A, hd, dtype, False) > _SMEM_MAX


def smem_bytes(A: int, hd: int, dtype) -> int:
    """Shared memory one block of the kernel takes for a cache of A rows
    and head dim hd: resident, bf16 keeps 16 rows of fp32 logits over its
    cluster rank's keys beside its Q (or split-combine park) and two K/V
    stages, f32 A fp32 logits; streaming, bf16 keeps Q, the park and four
    K/V stages, f32 one chunk of 128 logits."""
    return _plan_bytes(A, hd, dtype, streams(A, hd, dtype))


def _pad_hd(hd: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if hd <= p)


def bwd_plan(hd: int) -> dict:
    """The bf16 backward kernels' launch shape at head dim hd, from hd alone
    (``dq_smem``, ``dkv_warps`` and ``dkv_smem`` in
    ``csrc/row_attention.cu``): (a) a block of four warps per 16 rows,
    64-key tiles; (b) a block per 16 keys and, at hd 256, per half of the
    head dims (``halves``), of 8 warps (4 at hd 256); each kernel's shared
    memory per block in bytes."""
    hdp = _pad_hd(hd)
    ld, halves, warps = hdp + 8, 2 if hdp == 256 else 1, 8 if hdp <= 128 else 4
    dq = 2 * 16 * ld * 2 + max(2 * 2 * 64 * ld * 2, 4 * 16 * hdp * 4) + \
        (4 + 2 * 4) * 16 * 4
    stage = 2 * 16 * ld * 2 + 3 * 16 * 4
    dkv = 2 * 16 * ld * 2 + max(warps * 2 * stage,
                                2 * warps * 16 * (hdp // halves) * 4)
    return dict(hdp=hdp, rows=16, dq_keys=64, dkv_keys=16, halves=halves,
                dkv_warps=warps, dq_smem=dq, dkv_smem=dkv)


def _check_window(window):
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: no lower bound), got "
                         f"{window}")


def _check(q, k, v, qpos, window: int = 0):
    _check_window(window)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, Hq, hd), k and v (B, A, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} do "
                         f"not match (batch, head dim, Hq % Hkv == 0)")
    if hd > 256:
        raise ValueError(f"head dim {hd} > 256: the kernel's widest tile")
    if B > 65535:
        raise ValueError(f"batch {B} > 65535: one grid row per batch row")
    G = Hq // k.shape[2]
    blocks = (-(-Sq * G // 16) * k.shape[2] if q.dtype == torch.bfloat16
              else Sq * Hq)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{blocks} row blocks > 2^31 - 1: one grid column "
                         f"per block")
    if tuple(qpos.shape) != (B, Sq):
        raise ValueError(f"qpos must be {(B, Sq)}, got {tuple(qpos.shape)}")
    for name, t in (("k", k), ("v", v), ("qpos", qpos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cache dtypes {k.dtype}, {v.dtype} != q dtype "
                        f"{q.dtype}")


def _report(q, k):
    """The call as ``runtime.op_cost`` charges it: what the reference's
    ``_sdpa`` charges for the same call, its two einsums over the whole key
    span A with the KV heads repeated to Hq (``2 * B * Hq * Sq * A * hd``
    dot flops each, their operands and results in q's dtype), and the
    mask and softmax as elementwise flops. No weight bytes."""
    B, Sq, Hq, hd = q.shape
    A = k.shape[1]
    logits = B * Hq * Sq * A
    op_cost.charge_ops(
        dot_flops=4 * logits * hd, flops=5 * logits,
        nbytes=q.dtype.itemsize * (2 * B * Sq * Hq * hd + 2 * B * A * Hq * hd
                                   + 2 * logits))
    return torch.empty_like(q)


class _Recorded(torch.autograd.Function):
    """The attention as ``runtime.op_cost`` charges it when autograd
    records the call (the train step's walk): the forward ``_report``, and
    a backward that charges what the reference's gradient of ``_sdpa``
    charges, its four gradient einsums (``8 * B * Hq * Sq * A * hd`` dot
    flops, twice the forward's operand and result bytes) and the softmax's
    gradient as elementwise flops, and returns empty gradients of q, k and
    v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = (q, k, v)
        return _report(q, k)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.like
        B, Sq, Hq, hd = q.shape
        A = k.shape[1]
        logits = B * Hq * Sq * A
        op_cost.charge_ops(
            dot_flops=8 * logits * hd, flops=10 * logits,
            nbytes=2 * q.dtype.itemsize * (2 * B * Sq * Hq * hd
                                           + 2 * B * A * Hq * hd
                                           + 2 * logits))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _launch(q, k, v, qpos, window: int):
    """The forward kernel on CUDA tensors: (out, (q, k, v, qpos) as the
    kernel read them)."""
    global LAUNCHES
    _check(q, k, v, qpos, window)
    B, Sq, Hq, hd = q.shape
    A, Hkv = k.shape[1], k.shape[2]
    q = q.contiguous()
    k, v = _cache_view(k), _cache_view(v)
    qpos = qpos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, (q, k, v, qpos)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.row_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            out.data_ptr(), B, Sq, Hq, Hkv, A, hd, window, k.stride(0),
            v.stride(0), hd ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"row_attention launch failed: CUDA error {rc} "
                           f"(B={B}, Sq={Sq}, Hq={Hq}, Hkv={Hkv}, A={A}, "
                           f"hd={hd}, window={window})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return out, (q, k, v, qpos)


def row_attention_backward(dout, q, k, v, qpos, out, window: int = 0,
                           need_kv: bool = True):
    """(dq, dk, dv) of the attention for the output gradient ``dout``, on
    CUDA tensors, given the forward's output ``out``: kernel (a) (dQ and
    each row's logsumexp and D = dO . O), then kernel (b) (dK, dV; with
    ``need_kv`` False it is not launched and dk, dv are None), on the
    current stream, or raises. Gradients in the inputs' dtype, dk and dv
    contiguous (B, A, Hkv, hd)."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    window = int(window)
    if q.device.type != "cuda":
        raise ValueError(f"row_attention_backward runs on cuda, not "
                         f"{q.device}")
    _check(q, k, v, qpos, window)
    if dout.shape != q.shape or out.shape != q.shape or \
            dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} and out "
                         f"{tuple(out.shape)} {out.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    B, Sq, Hq, hd = q.shape
    A, Hkv = k.shape[1], k.shape[2]
    q, out, dout = q.contiguous(), out.contiguous(), dout.contiguous()
    k, v = _cache_view(k), _cache_view(v)
    qpos = qpos.to(torch.int32).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty((B, A, Hkv, hd), dtype=k.dtype, device=k.device) \
        if need_kv else None
    dv = torch.empty_like(dk) if need_kv else None
    if q.numel() == 0:
        if need_kv:
            dk.zero_()
            dv.zero_()
        return dq, dk, dv
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _library()
    dims = (B, Sq, Hq, Hkv, A, hd, window, k.stride(0), v.stride(0),
            hd ** -0.5, _DTYPE_CODE[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.row_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            out.data_ptr(), dout.data_ptr(), dq.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *dims, stream)
        if rc == 0:
            DQ_LAUNCHES += 1
            if need_kv:
                rc = lib.row_attention_bwd_dkv_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *dims, stream)
                if rc == 0:
                    DKV_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"row_attention backward launch failed: CUDA error "
                           f"{rc} (B={B}, Sq={Sq}, Hq={Hq}, Hkv={Hkv}, A={A}, "
                           f"hd={hd}, window={window})")
    return dq, dk, dv


class RowAttention(torch.autograd.Function):
    """The attention on CUDA tensors with the backward kernels as its
    gradient: q, k and v get gradients, qpos none."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, window):
        out, (qc, kc, vc, pc) = _launch(q, k, v, qpos, window)
        ctx.save_for_backward(qc, kc, vc, pc, out)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, out = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = row_attention_backward(dout, q, k, v, qpos, out,
                                            ctx.window, need_kv)
        return dq, dk, dv, None, None


def row_attention(q, k, v, qpos, window: int = 0):
    """Masked GQA attention, (B, Sq, Hq, hd) in q's dtype: each query
    attends to the keys in (qpos - window, qpos] (window 0: [0, qpos]).
    CPU tensors run the plain version (autograd differentiates it); CUDA
    tensors launch the kernel on the current stream or raise, through
    ``RowAttention`` when autograd records the call."""
    window = int(window)
    if op_cost.recording(q, k, v, qpos):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _Recorded.apply(q, k, v)
        return _report(q, k)
    if q.device.type == "cpu":
        return row_attention_plain(q, k, v, qpos, window)
    if q.device.type != "cuda":
        raise ValueError(f"row_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RowAttention.apply(q, k, v, qpos, window)
    return _launch(q, k, v, qpos, window)[0]
