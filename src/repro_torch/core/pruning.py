"""Coarse-grained block-wise value pruning (Sec. IV-C-1), on torch.

Port of ``repro.core.pruning``. The weight matrix W (K, N), K the
reduction dim and N the filters, is cut into non-overlapping 1 x alpha
blocks: the weights at one reduction position k across alpha consecutive
filters. Blocks are ranked by L2 norm and the lowest ``sparsity`` fraction
is zeroed.

The mask is byte-identical to the JAX package's numpy one on every device:
the norms are float32, summed in numpy's pairwise order (``_numpy_sum``)
with one correctly rounded IEEE operation at a time, the square root is
correctly rounded, and the ranking is a stable argsort.
"""

from __future__ import annotations

import math

import torch

DEFAULT_ALPHA = 8

_PAIRWISE_BLOCK = 128          # numpy's PW_BLOCKSIZE


def _numpy_sum(t):
    """Sum over the last axis in the order numpy's float32 ``add.reduce``
    takes on a contiguous axis (``pairwise_sum``): fewer than 8 terms
    left to right; up to 128 as eight strided partial sums combined as
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the remainder;
    longer axes split in two at a multiple of 8."""
    n = t.shape[-1]
    if n < 8:
        res = torch.zeros_like(t[..., 0])
        for i in range(n):
            res = res + t[..., i]
        return res
    if n <= _PAIRWISE_BLOCK:
        full = n - n % 8
        r = [t[..., j] for j in range(8)]
        for i in range(8, full, 8):
            r = [r[j] + t[..., i + j] for j in range(8)]
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(full, n):
            res = res + t[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _numpy_sum(t[..., :n2]) + _numpy_sum(t[..., n2:])


def block_l2_norms(w, alpha: int = DEFAULT_ALPHA):
    """float32 L2 norm per (k, n-block) of w (..., K, N), N % alpha == 0.
    Returns (..., K, N // alpha)."""
    w = torch.as_tensor(w)
    K, N = w.shape[-2], w.shape[-1]
    if N % alpha:
        raise ValueError(f"N={N} not divisible by alpha={alpha}")
    blocks = w.float().reshape(w.shape[:-2] + (K, N // alpha, alpha))
    # float64 sqrt rounded once to float32 is the correctly rounded float32
    # sqrt numpy takes; torch's vectorised float32 sqrt on the CPU is not
    return torch.sqrt(_numpy_sum(blocks * blocks).double()).float()


def block_prune_mask(w, sparsity: float, alpha: int = DEFAULT_ALPHA):
    """int32 mask (w's shape, on w's device) with the lowest-L2
    ``floor(sparsity * nblocks)`` blocks of each matrix zeroed (ties broken
    by a stable argsort, so the ratio is exact)."""
    w = torch.as_tensor(w)
    norms = block_l2_norms(w, alpha)                          # (..., K, B)
    flat = norms.reshape(norms.shape[:-2] + (-1,))
    k_prune = math.floor(float(sparsity) * flat.shape[-1])
    block_mask = torch.ones_like(flat, dtype=torch.int32)
    if k_prune > 0:
        order = torch.argsort(flat, dim=-1, stable=True)
        block_mask.scatter_(-1, order[..., :k_prune], 0)
    block_mask = block_mask.reshape(norms.shape)
    mask = block_mask[..., None].expand(norms.shape + (alpha,))
    return mask.reshape(w.shape).contiguous()


def apply_mask(w, mask):
    return w * torch.as_tensor(mask, device=w.device).to(w.dtype)


def value_sparsity(mask) -> float:
    m = torch.as_tensor(mask)
    return float(1.0 - int(m.sum()) / m.numel())


def surviving_block_indices(mask, alpha: int = DEFAULT_ALPHA):
    """Per filter group: the int32 indices of the K rows that keep any
    weight (the sparse allocation network's input list). mask (K, N)."""
    m = torch.as_tensor(mask)
    K, N = m.shape
    groups = m.reshape(K, N // alpha, alpha).bool().any(dim=-1)   # (K, G)
    return [torch.nonzero(groups[:, g]).flatten().to(torch.int32)
            for g in range(N // alpha)]
