"""Plain PyTorch oracles for the port's kernels."""

from __future__ import annotations

import torch


def joint_packed_ref(x, packed, out_dtype=torch.float32):
    """Oracle from the packed artifact itself (via unpack_joint_sparse):
    a dense fp32 matmul against the pruned, dequantized weights."""
    from . import ops
    w = ops.unpack_joint_sparse(packed)
    return (x.float() @ w).to(out_dtype)
