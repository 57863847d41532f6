"""Plain PyTorch oracles for the port's kernels: dense math on the
unpacked weights, independent of the packed layouts' code paths."""

from __future__ import annotations

import torch

from repro_torch.core.dyadic import unpack_terms


def block_sparse_matmul_ref(x, w_dense, mask):
    """Oracle for block_sparse_matmul: x @ the pruned W."""
    return x @ (w_dense * mask.to(w_dense.dtype))


def fta_int8_matmul_ref(x, w_q, scales, out_dtype=torch.bfloat16):
    """Oracle for fta_int8_matmul: fp32 x @ (w_q * scales), cast."""
    w = w_q.float() * scales.float()
    return (x.float() @ w).to(out_dtype)


def joint_sparse_matmul_ref(x, q_dense, mask, scales, out_dtype=torch.float32):
    """Oracle for joint_sparse_matmul: fp32 x @ the pruned, dequantized
    INT8 weights (q * mask * per-filter scale)."""
    w = q_dense.float() * mask.float() * scales.float()
    return (x.float() @ w).to(out_dtype)


def joint_packed_ref(x, packed, out_dtype=torch.float32):
    """Oracle from the packed artifact itself (via unpack_joint_sparse):
    a dense fp32 matmul against the pruned, dequantized weights."""
    from . import ops
    w = ops.unpack_joint_sparse(packed)
    return (x.float() @ w).to(out_dtype)


def dbmu_matmul_ref(x_int8, packed):
    """Oracle for dbmu_matmul: the integer matmul x @ unpack_terms(packed),
    int64, on x's device. It runs as a float64 product (CUDA has no integer
    matmul): every product and partial sum is an integer below 2^53, so it
    is exact."""
    x = torch.as_tensor(x_int8)
    w = unpack_terms(torch.as_tensor(packed, device=x.device))
    if x.shape[1] * 128 * 192 >= 2 ** 53:
        raise ValueError(f"K={x.shape[1]}: float64 sums may round")
    return (x.double() @ w.double()).to(torch.int64)
