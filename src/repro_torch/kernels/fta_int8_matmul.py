"""FTA/INT8 weight matmul: the bit-level sparsity path.

Port of the Pallas TPU kernel ``repro.kernels.fta_int8_matmul``.
FTA-projected weights are exact on the INT8 grid times a per-filter scale,
so they stay INT8 in device memory (half the bytes of bf16) and the scale
is applied once per output after the K sum:

  y = cast_out( (bf16(x) @ w_q) * scales )

x (M, K) f32 or bf16 is rounded to bf16 first, even when it is f32, as the
TPU kernel does; w_q (K, N) int8; scales (1, N) f32; the output dtype
defaults to bf16.

Three things live here:

  * ``fta_int8_matmul`` — the wrapper. A CPU tensor takes the plain
    version; a CUDA tensor launches the hand-written kernel
    (``csrc/fta_int8_matmul.cu``, bf16 tensor cores fed by TMA, built by
    ``nvcc`` for sm_90a on first use, loaded with ctypes) or raises. There
    is no fallback.
  * ``fta_int8_matmul_plain`` — the same function in plain PyTorch.
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

#: the TPU kernel's tiles; the per-layer hook packs the "bit" kind when
#: K % BK == 0 and N % BN == 0 and takes the kernel when rows % BM == 0
BM, BK, BN = 128, 512, 128

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

#: the CUDA kernel symbols a launch runs, as the profiler names them
SYMBOLS = ("fta_int8_matmul_kernel",)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def fta_int8_matmul_plain(x, w_q, scales, out_dtype=torch.bfloat16):
    """The same function in plain PyTorch: x rounded to bf16, an fp32
    matmul with the int8 weights (every product exact in fp32), the
    per-filter scale, the cast."""
    acc = x.to(torch.bfloat16).float() @ w_q.float()
    return (acc * scales.reshape(1, -1).float()).to(out_dtype)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("fta_int8_matmul")
        fn = lib.fta_int8_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, w_q, scales, out_dtype):
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"want x (M, K) and w_q (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}")
    for name, t in (("x", x), ("w_q", w_q), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q dtype {w_q.dtype} is not int8")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out dtype {out_dtype} not in (float32, bfloat16)")
    if scales.dtype != torch.float32 or scales.numel() != w_q.shape[1]:
        raise ValueError(f"scales must be float32 with {w_q.shape[1]} "
                         f"entries")


def _report(x, w_q, scales, out_dtype):
    """The call as ``runtime.op_cost`` charges it: the reference's
    ``pallas_call(x, w_q, scales)``, ``2 * M * K * N`` flops, the scales a
    (1, N) operand."""
    M, K = x.shape
    N = w_q.shape[1]
    op_cost.kernel(2 * M * K * N,
                   [x, w_q, op_cost.Operand((1, N), scales.dtype, scales)],
                   [op_cost.Operand((M, N), out_dtype)])
    return torch.empty((M, N), dtype=out_dtype, device=x.device)


def fta_int8_matmul(x, w_q, scales, out_dtype=torch.bfloat16):
    """x (M, K) @ (w_q (K, N) int8 * scales (1, N)) -> (M, N) in
    ``out_dtype``. CPU tensors run the plain version; CUDA tensors launch
    the kernel on the current stream (any M, K and N) or raise."""
    global LAUNCHES
    if op_cost.recording(x, w_q, scales):
        return _report(x, w_q, scales, out_dtype)
    if x.device.type == "cpu":
        return fta_int8_matmul_plain(x, w_q, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fta_int8_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, w_q, scales, out_dtype)
    M, K = x.shape
    N = w_q.shape[1]
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fta_int8_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), y.data_ptr(),
            M, K, N, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fta_int8_matmul launch failed: CUDA error {rc} "
                           f"(M={M}, K={K}, N={N})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return y
