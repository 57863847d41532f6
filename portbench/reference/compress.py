"""Frozen copy of the DB-PIM weight compression, as the configurations are
served (joint mode): column-balanced tile pruning, then per-filter INT8
with the Fixed-Threshold Approximation (FTA) projection. Returns the
dense float32 weight the compressed projection stands for, q * scale
with the pruned tiles zero.

Written from the paper's description and the serving format's stated
rules, not imported: the benchmark's yardstick does not move when the
program does.

  * tiles (bk, bn): min(128, dim rounded up to 8) per axis;
  * pruning: in every column of N tiles, drop the round(vs * kt) K tiles
    of least L2 norm (float64 sums, stable order; at least one kept);
  * INT8: one scale per output column over its kept weights, max|w| / 127
    + 1e-12 in float64 then float32; q = round half to even of w / scale,
    clamped to [-127, 127];
  * FTA (Alg. 1): phi(q) is the count of non-zero digits of q's canonical
    signed-digit form; a column's threshold is the mode of phi over its
    kept weights (ties to the smaller), 1 where the mode is 0, at most 2,
    0 for an all-zero column; every kept weight moves to the nearest INT8
    value with exactly that many digits (ties to the larger value).
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 128
MAX_PHI = 2
_DOMAIN = np.arange(-128, 128, dtype=np.int64)


def _csd_digits(v: int) -> int:
    """Non-zero digits of v's non-adjacent form."""
    n, count = int(v), 0
    while n:
        if n & 1:
            z = 2 - (n & 3)
            n -= z
            count += 1
        n >>= 1
    return count


PHI = np.array([_csd_digits(v) for v in _DOMAIN], dtype=np.int64)


def _projection_table() -> np.ndarray:
    """LUT[t, v + 128]: the INT8 value nearest v with exactly t digits,
    ties to the larger."""
    lut = np.zeros((MAX_PHI + 1, 256), dtype=np.int64)
    for t in range(MAX_PHI + 1):
        vals = _DOMAIN[PHI == t]
        for i, v in enumerate(_DOMAIN):
            d = np.abs(vals - v)
            lut[t, i] = vals[d == d.min()].max()
    return lut


LUT = _projection_table()


def tile_dims(K: int, N: int):
    def one(d):
        return min(TILE, max(8, 8 * -(-d // 8)))
    return one(K), one(N)


def kept_k_tiles(K: int, value_sparsity: float, bk: int) -> int:
    """K tiles kept in each column of N tiles."""
    kt = -(-K // bk)
    if not value_sparsity:
        return kt
    return kt - min(int(round(value_sparsity * kt)), kt - 1)


def balanced_mask(w: torch.Tensor, value_sparsity: float, bk: int, bn: int):
    """(K_pad, N_pad) int64 keep mask of a float32 (K, N) weight."""
    K, N = w.shape
    kt, nt = -(-K // bk), -(-N // bn)
    wp = torch.nn.functional.pad(w.double(), (0, nt * bn - N, 0, kt * bk - K))
    alive = torch.ones((kt, nt), dtype=torch.bool, device=w.device)
    n_drop = kt - kept_k_tiles(K, value_sparsity, bk)
    if n_drop > 0:
        norms = (wp.reshape(kt, bk, nt, bn) ** 2).sum(dim=(1, 3))
        order = torch.argsort(norms, dim=0, stable=True)
        alive.scatter_(0, order[:n_drop], False)
    return alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1).long()


def fta(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Alg. 1 on int64 q (K, N) under the keep mask m."""
    phi_t = torch.as_tensor(PHI, device=q.device)
    lut = torch.as_tensor(LUT, device=q.device)
    kept = m == 1
    phi = phi_t[q + 128]
    N = q.shape[1]
    cols = torch.arange(N, device=q.device).expand_as(q)
    counts = torch.bincount((phi * N + cols)[kept], minlength=9 * N)
    counts = counts.reshape(9, N)
    mode = torch.argmax(counts, dim=0)
    th = torch.where(mode == 0, torch.ones_like(mode),
                     torch.clamp(mode, max=MAX_PHI))
    empty = ((q.abs() * m).sum(dim=0) == 0) | (m.sum(dim=0) == 0)
    th = torch.where(empty, torch.zeros_like(th), th)
    return lut[th[None, :].expand_as(q), q + 128] * m


def compress_int8(w: torch.Tensor, value_sparsity: float):
    """(q int64 (K, N), scales float32 (N,)) of a (K, N) weight in its
    served dtype."""
    K, N = w.shape
    bk, bn = tile_dims(K, N)
    w = w.float()
    m = balanced_mask(w, value_sparsity, bk, bn)
    wp = torch.nn.functional.pad(w, (0, m.shape[1] - N, 0, m.shape[0] - K))
    wm = wp.double() * m.double()
    scales = (wm.abs().amax(dim=0) / 127.0 + 1e-12).float()
    q = torch.clamp(torch.round(wm / scales.double()), -127, 127).long()
    q = fta(q, m)
    return q[:K, :N], scales[:N]


def compress(w: torch.Tensor, value_sparsity: float) -> torch.Tensor:
    """The dense float32 (K, N) weight a compressed projection computes
    with: q * scale, zero where pruned."""
    q, scales = compress_int8(w, value_sparsity)
    return q.float() * scales
