"""Joint value-level x bit-level sparse matmul: the fused DB-PIM kernel.

Port of the Pallas TPU kernel ``repro.kernels.joint_sparse_matmul``. The
weight operand is compacted (value level: per N tile, only its surviving
K-blocks are stored) and quantized (bit level: INT8 payload on a
per-filter scale grid), so weight traffic is ``(1 - vs) * 0.5`` of dense
bf16. Packed layout (``kernels.ops.pack_joint_sparse``):

  w_blocks : (NT, MAXB, bk, bn) int8 (or bf16, the value-only payload)
  idx      : (NT, MAXB) int32   source K-block of each slot (0 in padding)
  scales   : (1, N) float32     per-filter scale, N = NT * bn

Three things live here:

  * ``joint_sparse_matmul`` — the wrapper. A CPU tensor takes the plain
    version; a CUDA tensor launches the hand-written kernel
    (``csrc/joint_sparse_matmul.cu`` with ``csrc/gather_matmul.cuh``: bf16
    x on the tensor cores, ``wgmma`` fed by TMA, split K over a cluster;
    f32 x in fp32 on the CUDA cores; built by ``nvcc`` for sm_90a on first
    use, loaded with ctypes) or raises. There is no fallback. Every row
    comes out bitwise the same whatever M is.
  * ``joint_sparse_matmul_plain`` — the same function in plain PyTorch:
    gather, dequantize to the activation dtype, fp32 matmul, scale, cast.
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
#: (csrc/gather_matmul.cuh, shared with block_sparse_matmul)
SYMBOLS = ("gathered_tc_kernel", "gathered_fp32_kernel")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LIB = None


def joint_sparse_matmul_plain(x, w_blocks, idx, scales, out_dtype=None):
    """x (M, K) @ joint-packed W -> (M, NT * bn) in plain PyTorch. Each N
    tile gathers its MAXB source K-blocks of x, multiplies them by the
    payload dequantized to x.dtype in fp32, and the per-filter scale is
    applied once before the cast, as in the kernel."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    M, K = x.shape
    NT, MAXB, bk, bn = w_blocks.shape
    xb = x.reshape(M, K // bk, bk)[:, idx.long()]           # (M, NT, MAXB, bk)
    xb = xb.permute(1, 0, 2, 3).reshape(NT, M, MAXB * bk).float()
    w = w_blocks.to(x.dtype).float().reshape(NT, MAXB * bk, bn)
    acc = torch.bmm(xb, w)                                   # (NT, M, bn) fp32
    y = acc.permute(1, 0, 2).reshape(M, NT * bn) * scales.reshape(1, -1).float()
    return y.to(out_dtype)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("joint_sparse_matmul")
        fn = lib.joint_sparse_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, w_blocks, idx, scales, out_dtype):
    if x.ndim != 2 or w_blocks.ndim != 4 or idx.ndim != 2:
        raise ValueError(f"want x (M, K), w_blocks (NT, MAXB, bk, bn), idx "
                         f"(NT, MAXB); got {tuple(x.shape)}, "
                         f"{tuple(w_blocks.shape)}, {tuple(idx.shape)}")
    NT, MAXB, bk, bn = w_blocks.shape
    for name, t in (("x", x), ("w_blocks", w_blocks), ("idx", idx),
                    ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if w_blocks.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"payload dtype {w_blocks.dtype} not in (int8, "
                        f"bfloat16)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out dtype {out_dtype} not in (float32, bfloat16)")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (NT, MAXB):
        raise ValueError(f"idx must be int32 {(NT, MAXB)}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if scales.dtype != torch.float32 or scales.numel() != NT * bn:
        raise ValueError(f"scales must be float32 with {NT * bn} entries")
    if not (0 < bk <= 128 and bk % 8 == 0 and bn > 0 and bn % 8 == 0):
        raise ValueError(f"bk={bk}, bn={bn}: both must be multiples of 8, "
                         f"bk at most 128")
    if x.shape[1] % bk:
        raise ValueError(f"K={x.shape[1]} is not a multiple of bk={bk} "
                         f"(ops.joint_dense pads K to k_pad)")


def _report(x, w_blocks, idx, scales, out_dtype):
    """The call as ``runtime.op_cost`` charges it: the reference's
    ``pallas_call(idx, x, w_blocks, scales)``, whose CostEstimate counts
    ``2 * M * NT * MAXB * bk * bn`` flops with M padded to the TPU row tile
    (``ops.pick_row_tile``: 8 rows in f32, 16 in bf16, then 128). This
    kernel masks ragged rows and pads nothing; the charge is the
    reference's, so both packages count the same work."""
    from .ops import pick_row_tile
    M, K = x.shape
    NT, MAXB, bk, bn = w_blocks.shape
    bm = pick_row_tile(M, x.dtype)
    Mp = -(-M // bm) * bm
    op_cost.kernel(2 * Mp * NT * MAXB * bk * bn,
                   [idx, op_cost.Operand((Mp, K), x.dtype, x), w_blocks,
                    scales],
                   [op_cost.Operand((Mp, NT * bn), out_dtype)])
    return torch.empty((M, NT * bn), dtype=out_dtype, device=x.device)


def joint_sparse_matmul(x, w_blocks, idx, scales, out_dtype=None):
    """x (M, K) @ joint-packed W -> (M, N), N = NT * bn; ``out_dtype``
    defaults to x.dtype. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream (any M: ragged rows are masked
    in the kernel) or raise."""
    global LAUNCHES
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if op_cost.recording(x, w_blocks, idx, scales):
        return _report(x, w_blocks, idx, scales, out_dtype)
    if x.device.type == "cpu":
        return joint_sparse_matmul_plain(x, w_blocks, idx, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"joint_sparse_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, w_blocks, idx, scales, out_dtype)
    M, K = x.shape
    NT, MAXB, bk, bn = w_blocks.shape
    y = torch.empty((M, NT * bn), dtype=out_dtype, device=x.device)
    if M == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.joint_sparse_matmul_launch(
            x.data_ptr(), w_blocks.data_ptr(), idx.data_ptr(),
            scales.data_ptr(), y.data_ptr(), M, K, NT, MAXB, bk, bn,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w_blocks.dtype],
            _DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"joint_sparse_matmul launch failed: CUDA error "
                           f"{rc} (M={M}, K={K}, NT={NT}, MAXB={MAXB}, "
                           f"bk={bk}, bn={bn})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return y
