"""Frozen cost functions: the operations and bytes a serving call needs,
from shapes alone.

Counts are of the compressed model (joint mode): a projection stores, in
each column of N tiles, ``kept_k_tiles`` K tiles of (bk, bn) INT8 weights
with a 4-byte index each and one 4-byte scale per output column
(``reference.compress``'s rules). A kernel's least time is the larger of
its bytes over the HBM rate and its operations over the bf16 peak; bytes
count each input read once and each output written once (the stored
pack, the scales and index, the activations in and out); operations count
the stored tiles against the valid rows only. Attention counts the live
keys only: K and V read once per slot and layer, 4 * keys * head_dim
operations per query head.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.harness import peaks
from portbench.reference import compress, slices


@dataclass(frozen=True)
class Proj:
    K: int
    N: int
    k_stored: int    # kept K tiles x bk
    n_pad: int       # N tiles x bn
    pack_bytes: int

    @classmethod
    def of(cls, K: int, N: int, vs: float) -> "Proj":
        bk, bn = compress.tile_dims(K, N)
        nt = -(-N // bn)
        kept = compress.kept_k_tiles(K, vs, bk)
        return cls(K, N, kept * bk, nt * bn,
                   nt * kept * bk * bn + nt * kept * 4 + nt * bn * 4)

    def launch(self, rows: int, valid: float):
        """(bytes, operations) of one launch over ``rows`` activation rows
        of which ``valid`` are real."""
        return (self.pack_bytes + rows * (self.K + self.N) * 2,
                2.0 * valid * self.k_stored * self.n_pad)


def least(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.BF16_FLOPS)


def capacity(spec: dict, tokens: int) -> int:
    """Rows each expert's launch computes for a group of ``tokens``."""
    k, E = spec["top_k"], spec["n_experts"]
    c = int(tokens * k / E * spec.get("capacity_factor", 1.25))
    return min(max(8, -(-c // 8) * 8), tokens * k)


class Costs:
    """The cost functions of one configuration at one engine geometry."""

    def __init__(self, spec: dict, slots: int):
        self.spec, self.slots = spec, slots
        vs = spec["dbpim_value_sparsity"]
        self.proj = {name: Proj.of(*shape, vs) for name, (shape, _)
                     in slices.weight_shapes(spec).items()}
        self.L = spec["n_layers"]
        self.hd = slices.hd(spec)

    def _keys(self, p: int) -> int:
        w = self.spec.get("window", 0)
        return min(p + 1, w) if w else p + 1

    # -- joint_sparse_matmul -------------------------------------------
    def joint_call(self, rows: int, valid: int) -> float:
        """Least seconds of one call's joint launches: ``rows`` rows per
        launch (slots, or slots x chunk), ``valid`` real tokens."""
        t = 0.0
        E = self.spec.get("n_experts", 0)
        for name, p in self.proj.items():
            if name.startswith("moe/"):
                # grouped per decode step (rows = slots); a chunk groups
                # per position: chunk groups of the slots' tokens
                groups = rows // self.slots
                c = capacity(self.spec, self.slots) * groups
                t += E * least(*p.launch(c, valid * self.spec["top_k"] / E))
            else:
                t += least(*p.launch(rows, valid))
        return self.L * t

    def _key_sum(self, start: int, n: int) -> int:
        """Live keys summed over the queries at positions start ..
        start + n - 1."""
        w = self.spec.get("window", 0)
        if not w or start + n <= w:
            return n * (start + 1) + n * (n - 1) // 2
        return sum(self._keys(p) for p in range(start, start + n))

    # -- row_attention ---------------------------------------------------
    def attention_call(self, segments) -> float:
        """Least seconds of one call's attention launches; ``segments``
        are (first position, tokens) of each slot's queries."""
        s = self.spec
        Hq, Hkv = s["n_heads"], s["n_kv_heads"]
        nbytes = ops = 0.0
        for start, n in segments:
            keys_read = self._keys(start + n - 1)
            nbytes += keys_read * Hkv * self.hd * 4 + n * Hq * self.hd * 4
            ops += 4.0 * self.hd * Hq * self._key_sum(start, n)
        return self.L * least(nbytes, ops)

    # -- whole model ------------------------------------------------------
    def span_ops(self, start: int, n: int) -> float:
        """Operations ``n`` tokens at positions start .. start + n - 1
        need through the compressed model's layers (top_k experts each);
        the unembedding is ``unembed_ops`` a generated token."""
        s = self.spec
        per_token = 0.0
        for name, pr in self.proj.items():
            mult = s["top_k"] if name.startswith("moe/") else 1
            per_token += 2.0 * mult * pr.k_stored * pr.n_pad
        if s.get("n_experts"):
            per_token += 2.0 * s["d_model"] * s["n_experts"]
        att = 4.0 * self.hd * s["n_heads"] * self._key_sum(start, n)
        return self.L * (n * per_token + att)

    def unembed_ops(self) -> float:
        return 2.0 * self.spec["d_model"] * self.spec["vocab_size"]
