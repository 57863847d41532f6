"""The plain float32 forward pass of the served configurations.

A decoder of ``n_layers`` pre-norm blocks: norm, grouped-query attention
with rotary positions on the first ``rope_pct`` of each head
(half-split rotation) and an optional sliding window, residual, norm, and
a SwiGLU MLP or a top-k mixture of SwiGLU experts (softmax over the
router's float32 logits, the k largest renormalised, every token served
by its k experts: dropless), residual; a final norm and the untied
unembedding. Norms are LayerNorm (scale and bias) or RMSNorm (scale),
eps 1e-6. Every projection computes with the compressed weight
(``compress.compress``) of the same seeded slice the program packs.

Runs layer by layer over a list of whole sequences, each from position 0,
building one layer's weights at a time on the device, so a mixtral-8x7b
fits beside nothing else. Float32 throughout, TF32 off; ``prec="fp8"``
rounds both operands of every product (projections, router, attention,
unembedding) to float8 e4m3 with one scale per tensor: the control that
must fail the comparison.
"""

from __future__ import annotations

import torch

from . import compress, slices

EPS = 1e-6
FP8_MAX = 448.0
QUERY_BLOCK = 512


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().max().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(prec: str):
    if prec == "fp32":
        return torch.matmul
    if prec == "fp8":
        return lambda a, b: torch.matmul(_fp8(a), _fp8(b))
    raise ValueError(f"precision {prec!r} not in ('fp32', 'fp8')")


def _norm(p, x):
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + EPS) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * p["scale"]


def _rope(x, pos, spec):
    """x (S, H, hd) at positions pos (S,)."""
    hd = x.shape[-1]
    rot = int(hd * spec.get("rope_pct", 1.0))
    rot -= rot % 2
    if rot == 0:
        return x
    inv = 1.0 / (spec.get("rope_theta", 10000.0)
                 ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                  device=x.device) / rot))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., rot:]], -1)


def _attention(p, h, spec, mm):
    S = h.shape[0]
    Hq, Hkv, hd = spec["n_heads"], spec["n_kv_heads"], slices.hd(spec)
    pos = torch.arange(S, device=h.device)
    q = _rope(mm(h, p["attn/wq"]).reshape(S, Hq, hd), pos, spec)
    k = _rope(mm(h, p["attn/wk"]).reshape(S, Hkv, hd), pos, spec)
    v = mm(h, p["attn/wv"]).reshape(S, Hkv, hd)
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, 1).transpose(0, 1)        # (Hq, S, hd)
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    q = q.transpose(0, 1)
    window = spec.get("window", 0)
    out = torch.empty_like(q)
    for q0 in range(0, S, QUERY_BLOCK):
        qb = q[:, q0:q0 + QUERY_BLOCK]
        qpos = pos[q0:q0 + QUERY_BLOCK, None]
        live = pos[None, :] <= qpos
        if window:
            live &= pos[None, :] > qpos - window
        s = mm(qb, k.transpose(1, 2)) * hd ** -0.5
        s = torch.where(live[None], s, float("-inf"))
        out[:, q0:q0 + QUERY_BLOCK] = mm(torch.softmax(s, -1), v)
    return mm(out.transpose(0, 1).reshape(S, Hq * hd), p["attn/wo"])


def _swiglu(x, wg, wu, wd, mm):
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


def _ffn(p, h, spec, mm):
    if not spec.get("n_experts"):
        return _swiglu(h, p["mlp/w_gate"], p["mlp/w_up"], p["mlp/w_down"], mm)
    probs = torch.softmax(mm(h, p["moe/router"]), -1)
    gate, idx = torch.topk(probs, spec["top_k"], dim=-1, sorted=True)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(h)
    for e, ex in enumerate(p["experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], ex["moe/w_gate"], ex["moe/w_up"],
                          ex["moe/w_down"], mm)
            y.index_add_(0, rows, out * gate[rows, slot, None])
    return y


def layer_weights(spec: dict, seed: int, layer: int, device) -> dict:
    """One layer's norms, router and compressed float32 projections."""
    vs = spec["dbpim_value_sparsity"]
    p = {"norm1": slices.norm(spec, seed, "norm1", device, layer),
         "norm2": slices.norm(spec, seed, "norm2", device, layer)}
    for name in slices.weight_shapes(spec):
        if name.startswith("moe/"):
            continue
        p[name] = compress.compress(
            slices.weight(spec, seed, name, layer, device), vs)
    if spec.get("n_experts"):
        p["moe/router"] = slices.router(spec, seed, layer, device)
        p["experts"] = [
            {name: compress.compress(
                slices.weight(spec, seed, name, layer, device, e), vs)
             for name in ("moe/w_gate", "moe/w_up", "moe/w_down")}
            for e in range(spec["n_experts"])]
    return p


@torch.no_grad()
def logits(spec: dict, seed: int, sequences, starts, device,
           prec: str = "fp32"):
    """Float32 logits (S_i - start_i, V) of each token sequence (1-D int
    tensors), from position ``start_i`` to its second-to-last: the
    logits that predict tokens start_i + 1 .. S_i - 1."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mm = _mm(prec)
        emb = slices.embeddings(spec, seed, device)
        xs = [emb["tok"][seq.to(device).long()].float() for seq in sequences]
        tok_out = emb["out"].float()
        del emb
        for layer in range(spec["n_layers"]):
            p = layer_weights(spec, seed, layer, device)
            for i, x in enumerate(xs):
                x = x + _attention(p, _norm(p["norm1"], x), spec, mm)
                xs[i] = x + _ffn(p, _norm(p["norm2"], x), spec, mm)
            del p
        final = slices.norm(spec, seed, "final_norm", device)
        return [mm(_norm(final, x[s:-1]), tok_out)
                for x, s in zip(xs, starts)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
