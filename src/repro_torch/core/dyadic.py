"""Dyadic Block (DB) decomposition of CSD words, on torch.

Port of ``repro.core.dyadic``. An 8-digit CSD word splits into four dyadic
blocks DB#k = (digit_{2k+1}, digit_{2k}). CSD non-adjacency leaves each
block at most ONE non-zero digit, so every block is either a

  * Zero pattern:  (0, 0)                  -> not stored
  * Comp pattern:  (0, +-1) or (+-1, 0)    -> one 6T cell (Q / Q-bar)

A Comp pattern is (block index, hi/lo position, sign): value
sign * 2^(2 * block + pos). DB-PIM stores only Comp patterns plus this
metadata (the offline compilation of Fig. 4).

Packed metadata (uint8 per term): bit0 = sign (1 => negative), bit1 = pos
(hi/lo within the block), bits 2-3 = block index, bit4 = valid.

A weight's term bytes depend only on its INT8 value, so ``pack_terms``
looks them up in a 256-entry table built once from ``pack_terms_numpy``
(the JAX package's algorithm): the pack is byte-identical to it on every
device by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .csd import CSD_DIGITS_TABLE, INT8_MAX, INT8_MIN, NDIGITS, to_csd

NBLOCKS = NDIGITS // 2
MAX_TERMS = 2  # FTA caps phi_th at 2 -> at most two Comp patterns per weight

_SIGN_BIT = 0
_POS_BIT = 1
_BLK_SHIFT = 2
_VALID_BIT = 4

_DOMAIN = np.arange(INT8_MIN, INT8_MAX + 1, dtype=np.int32)


def pack_terms_numpy(x, max_terms: int = MAX_TERMS) -> np.ndarray:
    """The reference algorithm on numpy int arrays: the Comp patterns of
    each weight, most significant block first, the first ``max_terms`` kept
    (FTA-projected weights have at most two). x.shape + (max_terms,)
    uint8."""
    x = np.asarray(x, dtype=np.int32)
    d = to_csd(x)
    blk = d.reshape(d.shape[:-1] + (NBLOCKS, 2))             # (..., 4, 2)
    lo, hi = blk[..., 0], blk[..., 1]
    digit = np.where(hi != 0, hi, lo)                        # (..., 4)
    pos = (hi != 0).astype(np.int32)
    valid = digit != 0
    enc = ((1 << _VALID_BIT)
           | (np.arange(NBLOCKS, dtype=np.int32) << _BLK_SHIFT)
           | (pos << _POS_BIT)
           | (digit < 0).astype(np.int32)).astype(np.uint8)
    enc_m = enc[..., ::-1]
    valid_m = valid[..., ::-1]
    rank = np.cumsum(valid_m, axis=-1)                       # 1-based rank
    out = np.zeros(x.shape + (max_terms,), dtype=np.uint8)
    for t in range(max_terms):
        sel = valid_m & (rank == t + 1)                      # one-hot block
        out[..., t] = np.sum(enc_m * sel, axis=-1).astype(np.uint8)
    return out


_PACK_LUT = {}


def _pack_lut(max_terms: int) -> np.ndarray:
    lut = _PACK_LUT.get(max_terms)
    if lut is None:
        lut = _PACK_LUT[max_terms] = pack_terms_numpy(_DOMAIN, max_terms)
    return lut


def _ints(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def dyadic_blocks(x) -> torch.Tensor:
    """CSD digits regrouped as blocks: int32 x.shape + (NBLOCKS, 2), (lo,
    hi) per block, on x's device."""
    x = _ints(x)
    table = torch.as_tensor(CSD_DIGITS_TABLE, device=x.device)
    d = table[x - INT8_MIN]
    return d.reshape(d.shape[:-1] + (NBLOCKS, 2))


def classify_blocks(x):
    """Per-block pattern class (int32: 0 = Zero, 1 = Comp) and whether
    every block held at most one non-zero digit (CSD non-adjacency)."""
    nnz = (dyadic_blocks(x) != 0).sum(dim=-1)
    return (nnz > 0).to(torch.int32), bool((nnz <= 1).all())


def pack_terms(x, max_terms: int = MAX_TERMS) -> torch.Tensor:
    """INT8 weights -> Comp-pattern term bytes, uint8 x.shape +
    (max_terms,), on x's device: a lookup in the table of
    ``pack_terms_numpy`` over all 256 INT8 values."""
    x = _ints(x)
    lut = torch.as_tensor(_pack_lut(max_terms), device=x.device)
    return lut[x - INT8_MIN]


def term_values(packed) -> torch.Tensor:
    """Each packed term byte's value, int32 ``valid * sign * 2^(2*blk +
    pos)``, same shape."""
    p = torch.as_tensor(packed).to(torch.int32)
    valid = (p >> _VALID_BIT) & 1
    sign = 1 - 2 * (p & 1)
    shift = 2 * ((p >> _BLK_SHIFT) & 3) + ((p >> _POS_BIT) & 1)
    return valid * sign * (torch.ones_like(p) << shift)


def unpack_terms(packed) -> torch.Tensor:
    """Exact int32 reconstruction from packed term bytes (last axis)."""
    return term_values(packed).sum(dim=-1).to(torch.int32)


def comp_pattern_stats(x):
    """(n_comp_blocks, n_zero_blocks, comp_fraction) over a tensor: DB-PIM
    stores exactly the Comp blocks (the U_act input)."""
    cls, ok = classify_blocks(x)
    if not ok:
        raise AssertionError("CSD non-adjacency violated (impossible for "
                             "valid CSD)")
    n_comp = int(cls.sum())
    n_total = cls.numel()
    return n_comp, n_total - n_comp, n_comp / max(n_total, 1)
