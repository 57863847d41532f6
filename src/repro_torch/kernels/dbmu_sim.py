"""Bit-true DBMU + CSD adder tree functional simulation.

Port of the Pallas TPU kernel ``repro.kernels.dbmu_sim``. It emulates the
DB-PIM macro datapath as the hardware computes it: inputs stream in
bit-serially (sign-magnitude planes); each stored Comp pattern (one 6T
cell, sign s, position p = 2 * blk + hi) ANDs the input bit, and the
CSD-based adder tree recombines the partials as

    out[n] = sum_k sum_bit sum_term  s * in_bit(k, bit) * 2^(bit + p)

The packed uint8 term layout is ``core.dyadic.pack_terms``'s (bit0 sign,
bit1 hi/lo, bits 2-3 block, bit4 valid). The result must equal the integer
matmul ``x_int8 @ unpack_terms(packed)`` exactly: this is the
hardware-equivalence oracle for the whole compression pipeline.

Three things live here:

  * ``dbmu_matmul`` — the wrapper. A CPU tensor takes the plain version; a
    CUDA tensor launches the hand-written kernel (``csrc/dbmu_matmul.cu``,
    integer arithmetic, built by ``nvcc`` for sm_90a on first use, loaded
    with ctypes) or raises. There is no fallback.
  * ``dbmu_matmul_plain`` — the same datapath in plain PyTorch, one
    float64 product per (term, input bit plane): every sum is an integer
    below 2^53, so each is exact.
  * ``LAUNCHES`` — the number of kernel launches so far, raised by one at
    each launch and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import dyadic
from . import build

INPUT_BITS = 8
MAX_TERMS = 2
#: the kernel's int32 accumulators hold 128 * 192 * K for K up to this
MAX_K = 87000

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

_LIB = None


def dbmu_matmul_plain(x_int8, packed):
    """x (M, K) int8-range ints; packed (K, N, 2) uint8 -> (M, N) int32,
    plane by plane and term by term as the TPU kernel sums them."""
    x = x_int8.to(torch.int32)
    sign_x = torch.where(x < 0, -1, 1).to(torch.int32)
    mag = x.abs()
    acc = torch.zeros((x.shape[0], packed.shape[1]), dtype=torch.int64,
                      device=x.device)
    for t in range(MAX_TERMS):
        term = dyadic.term_values(packed[..., t]).double()   # (K, N)
        for bit in range(INPUT_BITS):
            in_bit = ((mag >> bit) & 1) * sign_x             # (M, K) plane
            partial = in_bit.double() @ term
            acc += partial.to(torch.int64) << bit
    return acc.to(torch.int32)


def _library():
    global _LIB
    if _LIB is None:
        lib = build.load("dbmu_matmul")
        fn = lib.dbmu_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, packed):
    if x.ndim != 2 or packed.ndim != 3 or packed.shape[-1] != MAX_TERMS \
            or packed.shape[0] != x.shape[1]:
        raise ValueError(f"want x (M, K) and packed (K, N, {MAX_TERMS}); got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}")
    if packed.device != x.device:
        raise ValueError(f"packed is on {packed.device}, x on {x.device}")
    if x.dtype != torch.int32 or packed.dtype != torch.uint8:
        raise TypeError(f"want x int32 and packed uint8, got {x.dtype} and "
                        f"{packed.dtype}")
    if not (x.is_contiguous() and packed.is_contiguous()):
        raise ValueError("x and packed must be contiguous")
    if x.shape[1] > MAX_K:
        raise ValueError(f"K={x.shape[1]} > {MAX_K}: the int32 sums could "
                         f"overflow")


def dbmu_matmul(x_int8, packed):
    """x (M, K) int32 in int8 range; packed (K, N, 2) uint8 -> (M, N)
    int32. CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream (any M, K <= MAX_K, any N) or raise."""
    global LAUNCHES
    if x_int8.device.type == "cpu":
        return dbmu_matmul_plain(x_int8, packed)
    if x_int8.device.type != "cuda":
        raise ValueError(f"dbmu_matmul runs on cuda or cpu, not "
                         f"{x_int8.device}")
    _check(x_int8, packed)
    M, K = x_int8.shape
    N = packed.shape[1]
    y = torch.empty((M, N), dtype=torch.int32, device=x_int8.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    lib = _library()
    with torch.cuda.device(x_int8.device):
        stream = torch.cuda.current_stream(x_int8.device).cuda_stream
        rc = lib.dbmu_matmul_launch(x_int8.data_ptr(), packed.data_ptr(),
                                    y.data_ptr(), M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"dbmu_matmul launch failed: CUDA error {rc} "
                           f"(M={M}, K={K}, N={N})")
    LAUNCHES += 1
    return y
