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

Three things live here:

  * ``row_attention`` — the wrapper. A CPU tensor takes the plain version;
    a CUDA tensor launches the hand-written kernel
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
    Hq / Hkv, dtype) only, never on Sq, B or the positions.
  * ``row_attention_plain`` — the reference's math in plain PyTorch: KV
    heads repeated, einsum logits in the activations' dtype, -1e30 mask,
    fp32 softmax cast back, einsum with v.
  * ``LAUNCHES`` — the number of kernel launches so far, raised by one at
    each launch and nowhere else. A launch recorded into a CUDA graph
    runs at the graph's replays, which the host does not see: its capture
    counts nothing, and the launches inside replays are read from the
    device's own records (torch.profiler) by ``SYMBOLS``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

#: the CUDA kernel symbols a launch runs, as the profiler names them
SYMBOLS = ("attention_tc_kernel", "attention_stream_kernel",
           "attention_f32_kernel", "attention_f32_stream_kernel")

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


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("row_attention")
        fn = lib.row_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p])
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
    hdp = next(p for p in (16, 32, 64, 128, 256) if hd <= p)
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


def row_attention(q, k, v, qpos, window: int = 0):
    """Masked GQA attention, (B, Sq, Hq, hd) in q's dtype: each query
    attends to the keys in (qpos - window, qpos] (window 0: [0, qpos]).
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    global LAUNCHES
    window = int(window)
    if q.device.type == "cpu":
        return row_attention_plain(q, k, v, qpos, window)
    if q.device.type != "cuda":
        raise ValueError(f"row_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, qpos, window)
    B, Sq, Hq, hd = q.shape
    A, Hkv = k.shape[1], k.shape[2]
    q = q.contiguous()
    k, v = _cache_view(k), _cache_view(v)
    qpos = qpos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
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
    return out
