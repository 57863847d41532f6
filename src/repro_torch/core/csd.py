"""Canonical Signed Digit (CSD) encoding (Reitwiesner 1960).

CSD is the minimal-weight non-adjacent form (NAF): every integer has a unique
representation sum_i d_i 2^i with d_i in {-1, 0, +1} and d_i * d_{i+1} == 0.
For INT8 values (range [-128, 127]) eight digit positions (0..7) always
suffice. The tables here are built once in numpy over the 256-value INT8
domain; the torch side (core.fta, core.dyadic) only ever looks them up.
``csd_nonzero_count`` and ``phi_lookup`` take numpy arrays or torch tensors
and answer in kind (a tensor stays on its device).
"""

from __future__ import annotations

import numpy as np
import torch

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


def phi_lookup(x):
    """phi(x), the non-zero CSD digit count, by table lookup. numpy in ->
    numpy int32 out; a torch tensor -> an int32 tensor on its device."""
    if isinstance(x, torch.Tensor):
        table = torch.as_tensor(PHI_TABLE, device=x.device)
        return table[x.to(torch.int64) - INT8_MIN]
    return PHI_TABLE[np.asarray(x, dtype=np.int32) - INT8_MIN]


def csd_nonzero_count(x):
    """phi(x) of each element: from the digits for numpy input, from the
    table (the same counts) for a torch tensor."""
    if isinstance(x, torch.Tensor):
        return phi_lookup(x)
    return np.sum(to_csd(x) != 0, axis=-1).astype(np.int32)


def verify_csd_properties(values=None):
    """Check the three CSD invariants on a value set (default: all INT8):
    digits round-trip, no two adjacent digits are non-zero, and the digit
    count never exceeds the binary popcount of |v| (at least 1)."""
    if values is None:
        values = _DOMAIN
    values = np.asarray(values, dtype=np.int32)
    digits = to_csd(values)
    roundtrip = bool(np.all(from_csd(digits) == values))
    nonadjacent = bool(np.all(digits[..., 1:] * digits[..., :-1] == 0))
    popcnt = np.array([bin(abs(int(v))).count("1") for v in values.ravel()])
    minimal = bool(np.all(np.sum(digits != 0, axis=-1).ravel()
                          <= np.maximum(popcnt, 1)))
    return {"roundtrip": roundtrip, "nonadjacent": nonadjacent,
            "minimal": minimal}


def mean_nonzero_reduction() -> float:
    """Average reduction of non-zero digits against two's complement over
    the INT8 domain (the paper: about 33 %)."""
    csd_nnz = PHI_TABLE.astype(np.float64)
    twos = np.array([bin(int(v) & 0xFF).count("1") for v in _DOMAIN],
                    dtype=np.float64)
    nz = twos > 0
    return float(1.0 - csd_nnz[nz].sum() / twos[nz].sum())
