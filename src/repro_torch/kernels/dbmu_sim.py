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

x is int32. The datapath reads 8 sign-magnitude planes, so x enters as
x' = sign(x) * (|x| mod 256): every |x| <= 255 exactly, as in the
reference. The kernel takes x' as one int8 operand where it lies in
[-128, 127], and splits it as 4 h + l (two int8 operands) in the K tiles
where it does not.

What lives here:

  * ``dbmu_matmul`` — the wrapper. A CPU tensor takes the plain version; a
    CUDA tensor launches the hand-written kernel (``csrc/dbmu_matmul.cu``,
    int8 tensor cores, built by ``nvcc`` for sm_90a on first use, loaded
    with ctypes) or raises. There is no fallback.
  * ``dbmu_matmul_plain`` — the same datapath in plain PyTorch, one
    float64 product per (term, input bit plane): every sum is an integer
    below 2^53, so each is exact.
  * ``term_table``, ``pair_table``, ``block_operands`` and
    ``dbmu_matmul_blocks`` — the kernel's exact evaluation in plain
    PyTorch. The input planes fold back into x'; the weight splits by DB
    block position b into int8 operands S_b in [-4, 4] (``pair_table``
    maps a pair of term bytes to its four S_b from two ``term_table``
    words, as the kernel's decode does), and y = sum_b (x' @ S_b) << 2b.
  * ``LAUNCHES`` — the number of kernel launches so far, raised by one at
    each launch and nowhere else. A launch recorded into a CUDA graph
    runs at the graph's replays, which the host does not see: its capture
    counts nothing, and the launches inside replays are read from the
    device's own records (torch.profiler) by ``SYMBOLS``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import dyadic
from repro_torch.runtime import op_cost
from . import build

INPUT_BITS = 8
MAX_TERMS = 2
#: DB block positions of an 8-digit CSD word
NBLOCKS = 4
#: the longest K the kernel takes: y of pack_terms' packs (|y| <= 128 *
#: 192 * K for int8-range x) fits int32, and each of the kernel's int32
#: accumulators (at most 1272 * K) stays far inside it; longer sums would
#: wrap
MAX_K = 87000

#: kernel launches so far in this process (the wrapper's CUDA branch only)
LAUNCHES = 0

#: the CUDA kernel symbols a launch runs, as the profiler names them
SYMBOLS = ("dbmu_matmul_kernel",)

_LIB = None


def dbmu_matmul_plain(x_int8, packed):
    """x (M, K) int32; packed (K, N, 2) uint8 -> (M, N) int32, plane by
    plane and term by term as the TPU kernel sums them: the 8 magnitude
    planes of x, so |x| <= 255 is exact."""
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


def term_table() -> torch.Tensor:
    """(32,) int64 words, the kernel's per-term table: byte b of word t is
    4 + (blk_t == b ? valid_t * sign_t * 2^(hi_t) : 0), for the low five
    bits t of a term byte (bits 5-7 carry nothing)."""
    t = torch.arange(32, dtype=torch.int64)
    value = ((t >> 4) & 1) * (1 - 2 * (t & 1)) * (1 << ((t >> 1) & 1))
    b = torch.arange(NBLOCKS)
    byte = torch.where(((t >> 2) & 3)[:, None] == b[None], value[:, None], 0) + 4
    return (byte << (8 * b)[None]).sum(dim=1)


def pair_table() -> torch.Tensor:
    """(1024, 4) int8: row t0 | t1 << 5 holds S_0..S_3 of a weight whose
    term bytes have low five bits t0 and t1,

        S_b = sum_t valid_t * sign_t * 2^(hi_t) * [blk_t == b],

    each in [-4, 4], formed as the kernel forms it: the two term words
    added (every byte in [4, 12], so no carries), then
    (sum + 0x78787878) ^ 0x80808080, which takes 8 off each byte as an
    int8."""
    tw = term_table()
    words = ((tw[None, :] + tw[:, None]) + 0x78787878) ^ 0x80808080   # [t1, t0]
    shifts = 8 * torch.arange(NBLOCKS)
    return ((words.reshape(1024, 1) >> shifts) & 0xFF).to(torch.uint8) \
        .view(torch.int8)


def block_operands(packed) -> torch.Tensor:
    """packed (K, N, 2) uint8 -> (4, K, N) int8, the block operands S_b
    of each weight: unpack_terms(packed) == sum_b S_b * 4^b."""
    p = packed.to(torch.int64) & 31
    idx = p[..., 0] | (p[..., 1] << 5)
    return pair_table().to(packed.device)[idx].permute(2, 0, 1)


def input_operand(x):
    """x' = sign(x) * (|x| mod 256), the value the datapath's 8 magnitude
    planes of x carry (int64)."""
    x = x.to(torch.int32)
    mag = x.abs() & 255                  # |INT_MIN| wraps to itself: 0
    return torch.where(x < 0, -mag, mag).to(torch.int64)


def dbmu_matmul_blocks(x_int8, packed):
    """The kernel's arithmetic in plain PyTorch: y = sum_b (x' @ S_b) << 2b
    (``input_operand``; the kernel's split of x' = 4 h + l sums to the
    same integers), each product in float64 (integers below 2^53, exact),
    the sum modulo 2^32 as int32 (the kernel's uint32 shift-add)."""
    s = block_operands(packed).double()
    x = input_operand(x_int8).double()
    acc = torch.zeros((x.shape[0], packed.shape[1]), dtype=torch.int64,
                      device=x.device)
    for b in range(NBLOCKS):
        acc += (x @ s[b]).to(torch.int64) << (2 * b)
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


def _report(x, packed):
    """The call as ``runtime.op_cost`` charges it: the reference's
    ``pallas_call(x, w0, w1)`` over the two (K, N) term planes, with no
    CostEstimate, so the reference walks its body once per grid step: one
    (BM, K) @ (K, BN) product per term and input bit, ``MAX_TERMS *
    INPUT_BITS * 2 * M * K * N`` flops in all. Its integer activation
    counts as a weight operand there, and here."""
    M, K = x.shape
    N = packed.shape[1]
    plane = op_cost.Operand((K, N), packed.dtype, packed)
    op_cost.kernel(MAX_TERMS * INPUT_BITS * 2 * M * K * N,
                   [x, plane, plane],
                   [op_cost.Operand((M, N), torch.int32)])
    return torch.empty((M, N), dtype=torch.int32, device=x.device)


def dbmu_matmul(x_int8, packed):
    """x (M, K) int32; packed (K, N, 2) uint8 -> (M, N) int32, the integer
    matmul of x' = sign(x) * (|x| mod 256) (x itself for |x| <= 255) with
    the packed weights. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream (any M, K <= MAX_K, any N) or
    raise. Both give the same integers for every x."""
    global LAUNCHES
    if op_cost.recording(x_int8, packed):
        return _report(x_int8, packed)
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
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return y
