"""Block-sparse matmul: the value-level sparsity path.

Port of the Pallas TPU kernel ``repro.kernels.block_sparse_matmul``. The
weight is stored compacted: for every N-column tile only its surviving
K-blocks, plus an index table, so weight traffic and work scale with
``1 - value_sparsity``. Packed layout (``kernels.ops.pack_block_sparse``):

  w_blocks : (NT, MAXB, bk, bn) in x's dtype, zero blocks in padded slots
  idx      : (NT, MAXB) int32   source K-block of each slot (0 in padding)

Three things live here:

  * ``block_sparse_matmul`` — the wrapper. A CPU tensor takes the plain
    version; a CUDA tensor launches the hand-written kernel
    (``csrc/block_sparse_matmul.cu``, the gathered-K kernels of
    ``csrc/gather_matmul.cuh`` that the joint kernel runs: bf16 on the
    tensor cores, f32 in fp32 on the CUDA cores; built by ``nvcc`` for
    sm_90a on first use, loaded with ctypes) or raises. There is no
    fallback.
  * ``block_sparse_matmul_plain`` — the same function in plain PyTorch:
    gather, fp32 batched matmul, cast.
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

#: the TPU kernel's tiles (ops.pack_block_sparse packs at BK x BN; the
#: per-layer hook takes the kernel only when rows % BM == 0)
BM, BK, BN = 128, 128, 128

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

#: the CUDA kernel symbols a launch runs, as the profiler names them
#: (csrc/gather_matmul.cuh, shared with joint_sparse_matmul)
SYMBOLS = ("gathered_tc_kernel", "gathered_fp32_kernel")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def block_sparse_matmul_plain(x, w_blocks, idx):
    """x (M, K) @ block-sparse W -> (M, NT * bn) in x's dtype, in plain
    PyTorch: each N tile gathers its MAXB source K-blocks of x and
    multiplies them by its payload in fp32."""
    M, K = x.shape
    NT, MAXB, bk, bn = w_blocks.shape
    xb = x.reshape(M, K // bk, bk)[:, idx.long()]           # (M, NT, MAXB, bk)
    xb = xb.permute(1, 0, 2, 3).reshape(NT, M, MAXB * bk).float()
    w = w_blocks.float().reshape(NT, MAXB * bk, bn)
    acc = torch.bmm(xb, w)                                   # (NT, M, bn) fp32
    return acc.permute(1, 0, 2).reshape(M, NT * bn).to(x.dtype)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("block_sparse_matmul")
        fn = lib.block_sparse_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, w_blocks, idx):
    if x.ndim != 2 or w_blocks.ndim != 4 or idx.ndim != 2:
        raise ValueError(f"want x (M, K), w_blocks (NT, MAXB, bk, bn), idx "
                         f"(NT, MAXB); got {tuple(x.shape)}, "
                         f"{tuple(w_blocks.shape)}, {tuple(idx.shape)}")
    NT, MAXB, bk, bn = w_blocks.shape
    for name, t in (("x", x), ("w_blocks", w_blocks), ("idx", idx)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if w_blocks.dtype != x.dtype:
        raise TypeError(f"payload dtype {w_blocks.dtype} != x dtype "
                        f"{x.dtype} (the hook casts it to x's dtype)")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (NT, MAXB):
        raise ValueError(f"idx must be int32 {(NT, MAXB)}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not (0 < bk <= 128 and bk % 8 == 0 and bn > 0 and bn % 8 == 0):
        raise ValueError(f"bk={bk}, bn={bn}: both must be multiples of 8, "
                         f"bk at most 128")
    if x.shape[1] % bk:
        raise ValueError(f"K={x.shape[1]} is not a multiple of bk={bk}")


def _report(x, w_blocks, idx):
    """The call as ``runtime.op_cost`` charges it: the reference's
    ``pallas_call(idx, x, w_blocks)``, ``2 * M * NT * MAXB * bk * bn``
    flops (the stored blocks only)."""
    M = x.shape[0]
    NT, MAXB, bk, bn = w_blocks.shape
    op_cost.kernel(2 * M * NT * MAXB * bk * bn, [idx, x, w_blocks],
                   [op_cost.Operand((M, NT * bn), x.dtype)])
    return torch.empty((M, NT * bn), dtype=x.dtype, device=x.device)


def block_sparse_matmul(x, w_blocks, idx):
    """x (M, K) @ block-sparse W -> (M, N) in x's dtype, N = NT * bn. CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (any M: ragged rows are masked in the kernel) or
    raise."""
    global LAUNCHES
    if op_cost.recording(x, w_blocks, idx):
        return _report(x, w_blocks, idx)
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, w_blocks, idx)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, w_blocks, idx)
    M, K = x.shape
    NT, MAXB, bk, bn = w_blocks.shape
    y = torch.empty((M, NT * bn), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.block_sparse_matmul_launch(
            x.data_ptr(), w_blocks.data_ptr(), idx.data_ptr(), y.data_ptr(),
            M, K, NT, MAXB, bk, bn, _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"block_sparse_matmul launch failed: CUDA error "
                           f"{rc} (M={M}, K={K}, NT={NT}, MAXB={MAXB}, "
                           f"bk={bk}, bn={bn})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return y
