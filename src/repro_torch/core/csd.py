"""Canonical Signed Digit (CSD) encoding (Reitwiesner 1960).

CSD is the minimal-weight non-adjacent form (NAF): every integer has a unique
representation sum_i d_i 2^i with d_i in {-1, 0, +1} and d_i * d_{i+1} == 0.
For INT8 values (range [-128, 127]) eight digit positions (0..7) always
suffice. The tables here are built once in numpy over the 256-value INT8
domain; the torch side (core.fta) only ever looks them up.
"""

from __future__ import annotations

import numpy as np

NDIGITS = 8
INT8_MIN, INT8_MAX = -128, 127


def to_csd(x) -> np.ndarray:
    """Convert integers in [-128, 127] to CSD digits, shape x.shape + (8,).

    NAF recurrence: z = 2 - (n mod 4) when n is odd else 0, n <- (n - z)/2.
    """
    n = np.asarray(x, dtype=np.int32)
    digits = []
    for _ in range(NDIGITS):
        odd = n & 1
        rem4 = n & 3
        z = np.where(odd == 1, np.where(rem4 == 1, 1, -1), 0).astype(np.int32)
        digits.append(z)
        n = (n - z) >> 1
    return np.stack(digits, axis=-1)


def from_csd(digits) -> np.ndarray:
    """Inverse of :func:`to_csd`. Accepts any trailing digit count."""
    d = np.asarray(digits, dtype=np.int32)
    weights = 1 << np.arange(d.shape[-1], dtype=np.int32)
    return np.sum(d * weights, axis=-1)


# Index convention: table[v + 128] corresponds to the value v.
_DOMAIN = np.arange(INT8_MIN, INT8_MAX + 1, dtype=np.int32)          # (256,)
CSD_DIGITS_TABLE = to_csd(_DOMAIN)                                   # (256, 8)
PHI_TABLE = np.sum(CSD_DIGITS_TABLE != 0, axis=-1).astype(np.int32)  # (256,)
