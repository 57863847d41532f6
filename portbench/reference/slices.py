"""Seeded weight slices, the inputs both sides are built from.

Every slice is drawn on its own from ``(seed, name, layer, expert)``, so
the program's builder and the reference draw the same numbers one slice at
a time, in any order, and a mixtral-8x7b's dense experts never exist at
once. Draws come from a ``torch.Generator`` on the slice's device: normal
(0, 1) in float32, times the slice's scale, rounded to the dtype the
configuration serves in (routers and norms stay float32, as the program
keeps them).
"""

from __future__ import annotations

import hashlib

import torch

#: spread of the norms' scales around 1 and of their biases around 0: the
#: benchmark draws them, so a norm's scale and bias paths do work
NORM_SPREAD = 0.1


def slice_seed(seed: int, name: str, layer: int = -1, expert: int = -1) -> int:
    """A 63-bit generator seed for one slice."""
    key = f"{int(seed)}|{name}|{int(layer)}|{int(expert)}".encode()
    return int(hashlib.sha256(key).hexdigest()[:15], 16)


def normal(seed: int, name: str, shape, device, layer: int = -1,
           expert: int = -1) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(slice_seed(seed, name, layer, expert))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def dtype_of(spec: dict) -> torch.dtype:
    return torch.bfloat16 if spec["dtype"] == "bfloat16" else torch.float32


def hd(spec: dict) -> int:
    return spec.get("head_dim") or spec["d_model"] // spec["n_heads"]


def weight_shapes(spec: dict) -> dict:
    """{slice name: ((K, N), scale)} of one layer's projections, and of
    one expert's for the ``moe/`` names."""
    d, f = spec["d_model"], spec["d_ff"]
    q_dim, kv_dim = spec["n_heads"] * hd(spec), spec["n_kv_heads"] * hd(spec)
    out = {"attn/wq": ((d, q_dim), d ** -0.5),
           "attn/wk": ((d, kv_dim), d ** -0.5),
           "attn/wv": ((d, kv_dim), d ** -0.5),
           "attn/wo": ((q_dim, d), q_dim ** -0.5)}
    ffn = "moe" if spec.get("n_experts") else "mlp"
    out[f"{ffn}/w_gate"] = ((d, f), d ** -0.5)
    out[f"{ffn}/w_up"] = ((d, f), d ** -0.5)
    out[f"{ffn}/w_down"] = ((f, d), f ** -0.5)
    return out


def weight(spec: dict, seed: int, name: str, layer: int, device,
           expert: int = -1) -> torch.Tensor:
    """One projection slice (K, N) in the served dtype."""
    shape, scale = weight_shapes(spec)[name]
    w = normal(seed, name, shape, device, layer, expert) * scale
    return w.to(dtype_of(spec))


def router(spec: dict, seed: int, layer: int, device) -> torch.Tensor:
    """The (d, E) float32 router of one MoE layer."""
    d = spec["d_model"]
    return normal(seed, "moe/router", (d, spec["n_experts"]), device,
                  layer) * d ** -0.5


def norm(spec: dict, seed: int, name: str, device, layer: int = -1) -> dict:
    """{"scale"} (RMSNorm) or {"scale", "bias"} (LayerNorm), float32."""
    d = spec["d_model"]
    out = {"scale": 1.0 + NORM_SPREAD * normal(seed, f"{name}/scale", (d,),
                                               device, layer)}
    if spec.get("norm_type") == "layernorm":
        out["bias"] = NORM_SPREAD * normal(seed, f"{name}/bias", (d,),
                                           device, layer)
    return out


def embeddings(spec: dict, seed: int, device) -> dict:
    """{"tok" (V, d), "out" (d, V)} in the served dtype."""
    V, d = spec["vocab_size"], spec["d_model"]
    dt = dtype_of(spec)
    return {"tok": normal(seed, "embed/tok", (V, d), device).to(dt),
            "out": (normal(seed, "embed/out", (d, V), device)
                    * d ** -0.5).to(dt)}
