"""Mixture-of-Experts with sort-free capacity dispatch, for the serving
path.

Port of ``repro.models.moe``: top-k routing over an f32 router, per-group
capacity ``C = capacity(cfg, Tg)``, dispatch of each (token, choice) pair
to its expert's next free slot, the expert FFN on (E, C, D) buffers, and
the gate-weighted combine. Assignments past an expert's capacity are
dropped, as in the reference (Switch behaviour).

Every op has a fixed shape and none reads a value back to the host, so a
step that runs MoE layers is captured whole in a CUDA graph. JAX's
``mode="drop"`` scatter and ``mode="fill"`` gather become a buffer of
``E * C + 1`` rows whose last row is a dump row: dropped assignments are
written there (the only index that can repeat; what lands there is
discarded) and read back from there as zeros.

Chunk == stepwise decode holds bitwise when each op of a chunk computes a
token's row as a decode step computes it:

  * per-position grouping (``per_position=True``, chunked prefill): each
    chunk position's pool is the B slot tokens of that position, the pool
    one decode step routes;
  * the router runs one (Tg, D) @ (D, E) product per group, so a chunk's
    router runs at decode's row count (a larger product may be summed in
    another order by the library);
  * top-k is ``torch.topk(sorted=True)``, which, like ``jax.lax.top_k``,
    puts the lower index first on ties; the combine is an ordered sum over
    the k choices, row by row;
  * the expert projections run through the row-stable joint kernel (the
    ``expert`` attribute of the stacked tables' hook), whose rows do not
    depend on how many rows share a launch.

Every expert runs every step on its C rows, filled or not, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal, apply_mlp, dtype_of, init_mlp


def _expert_stack(gen, lead, E, d_in, d_out, scale, dt, device, name,
                  expert_sink):
    """An (L, E, d_in, d_out) expert stack drawn one (layer, expert) slice
    at a time, layer-major. With ``expert_sink`` each slice goes to
    ``expert_sink(name, l, e, w)`` instead and the stack is an (L, 1, 1)
    zero placeholder (``strip_packed_projections``' own); on the meta
    device, shapes only."""
    if device.type == "meta":
        return torch.empty(lead + (E, d_in, d_out), dtype=dt, device=device)
    out = (torch.empty(lead + (E, d_in, d_out), dtype=dt, device=device)
           if expert_sink is None
           else torch.zeros((lead[0], 1, 1), dtype=dt, device=device))
    for l in range(lead[0]):
        for e in range(E):
            w = (_normal(gen, (d_in, d_out), device) * scale).to(dt)
            if expert_sink is None:
                out[l, e] = w
            else:
                expert_sink(f"moe/{name}", l, e, w)
    return out


def init_moe(cfg: ModelConfig, gen, device, lead, expert_sink=None):
    """Router (L, d, E) float32 and the expert stacks (L, E, d, f), (L, E,
    f, d) in cfg.dtype (w_gate only for gated MLPs), with the JAX
    package's scales. ``lead`` is the (L,) stack of the segment."""
    dt = dtype_of(cfg)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    p = {"router": _normal(gen, lead + (d, E), device) * s}
    stacks = [("w_up", d, f, s), ("w_down", f, d, f ** -0.5)]
    if cfg.mlp_type in ("swiglu", "geglu"):
        stacks.insert(0, ("w_gate", d, f, s))
    for name, d_in, d_out, scale in stacks:
        p[name] = _expert_stack(gen, lead, E, d_in, d_out, scale, dt, device,
                                name, expert_sink)
    return p


def init_moe_block(cfg: ModelConfig, gen, device, lead, expert_sink=None):
    """The MoE params, and arctic's dense residual MLP beside them."""
    p = init_moe(cfg, gen, device, lead, expert_sink)
    if cfg.dense_residual:
        p["dense_mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, device,
                                  lead)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert token slots: rounded up to a multiple of 8, but never
    beyond the assignment count n_tokens * top_k (a tiny decode batch
    allocates exactly that many)."""
    assignments = n_tokens * cfg.top_k
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return min(max(8, -(-c // 8) * 8), assignments)


def _route(xg, router, k: int):
    """Top-k routing of grouped tokens xg (G, Tg, D): (probs (G, Tg, E),
    gate values renormalized over the k choices, gate indices (G, Tg,
    k)). The f32 router logits are one (Tg, D) @ (D, E) product per
    group, so a chunk's per-position groups run decode's product."""
    logits = torch.stack([xg[g].float().contiguous() @ router
                          for g in range(xg.shape[0])])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _group_dispatch(xt, gate_idx, gate_vals, E: int, C: int):
    """One group of Tg tokens: (xin (E, C, D), slot (Tg*K,), w (Tg, K)).
    Assignment i goes to slot ``expert * C + rank`` where rank counts the
    earlier assignments to the same expert; past capacity it goes to the
    dump row E*C and its gate weight is zeroed."""
    Tg, D = xt.shape
    K = gate_idx.shape[-1]
    flat_e = gate_idx.reshape(-1)                           # (Tg*K,)
    onehot = (flat_e[:, None] == torch.arange(E, device=xt.device)
              ).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    rank = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank,
                       torch.full_like(flat_e, E * C))
    buf = xt.new_zeros((E * C + 1, D))
    updates = xt[:, None, :].expand(Tg, K, D).reshape(Tg * K, D)
    buf.index_copy_(0, slot, updates)
    w = gate_vals * keep.reshape(Tg, K)
    return buf[:E * C].reshape(E, C, D), slot, w


def _group_combine(out_ec, slot, w, Tg: int):
    """Inverse gather of one group: out_ec (E, C, D) -> (Tg, D), the k
    choices summed in order in f32 (a dropped one reads the zero dump
    row)."""
    E, C, D = out_ec.shape
    flat = torch.cat([out_ec.reshape(E * C, D), out_ec.new_zeros((1, D))])
    gathered = flat[slot].reshape(Tg, -1, D).float()
    wf = w.to(out_ec.dtype).float()
    y = gathered[:, 0] * wf[:, 0, None]
    for k in range(1, gathered.shape[1]):
        y = y + gathered[:, k] * wf[:, k, None]
    return y.to(out_ec.dtype)


def apply_moe(p, x, cfg: ModelConfig, expert_fn=None,
              per_position: bool = False):
    """x (B, S, D) -> (B, S, D), and the aux dict (load_balance,
    dropped_frac).

    Groups: per sequence position (``per_position``, chunked prefill: S
    groups of the B slot tokens, capacity(cfg, B)); per sequence when S >=
    64 (B groups of S tokens); else one flat group of B * S tokens (a
    decode step). ``expert_fn`` routes the expert contractions through the
    stacked tables' ``expert`` hook."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if per_position:
        G, Tg = S, B
        xg = x.transpose(0, 1)                              # (S, B, D)
    elif S >= 64:
        G, Tg = B, S
        xg = x
    else:
        G, Tg = 1, B * S
        xg = x.reshape(G, Tg, D)
    C = capacity(cfg, Tg)

    probs, gate_vals, gate_idx = _route(xg, p["router"], K)

    groups = [_group_dispatch(xg[g], gate_idx[g], gate_vals[g], E, C)
              for g in range(G)]
    xin = torch.stack([grp[0] for grp in groups])           # (G, E, C, D)
    out = _expert_ffn_grouped(p, xin, cfg, expert_fn)       # (G, E, C, D)
    yg = torch.stack([_group_combine(out[g], grp[1], grp[2], Tg)
                      for g, grp in enumerate(groups)])     # (G, Tg, D)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = (gate_idx[..., :1] == torch.arange(E, device=x.device)
          ).float().mean(dim=(0, 1))
    slots = torch.stack([grp[1] for grp in groups])
    aux = {"load_balance": E * (me * ce).sum(),
           "dropped_frac": 1.0 - (slots < E * C).float().mean()}
    y = yg.transpose(0, 1) if per_position else yg.reshape(B, S, D)
    return y, aux


def _expert_ffn_grouped(p, xin, cfg: ModelConfig, expert_fn=None):
    """xin (G, E, C, D) -> (G, E, C, D): the expert MLP (gated, or plain
    gelu), each contraction x (..., E, C, K) @ w (E, K, F) through
    ``expert_fn`` (the stacked tables' ``expert`` hook: one joint launch
    per packed expert slice) or a plain einsum."""
    def mm(name, v):
        if expert_fn is not None:
            return expert_fn(p[name], v, f"moe/{name}")
        return torch.einsum("...eck,ekf->...ecf", v, p[name])
    if cfg.mlp_type == "gelu":
        return mm("w_down", F.gelu(mm("w_up", xin), approximate="tanh"))
    gate = mm("w_gate", xin)
    g = (F.silu(gate) if cfg.mlp_type == "swiglu"
         else F.gelu(gate, approximate="tanh"))
    return mm("w_down", g * mm("w_up", xin))


def apply_moe_block(p, x, cfg: ModelConfig, dense_fn=None,
                    per_position: bool = False):
    """MoE, plus arctic's dense residual MLP in parallel. ``dense_fn`` is
    the layer's stacked-tables hook: its ``expert`` attribute serves the
    expert projections, the hook itself the dense residual MLP; None keeps
    every matmul plain."""
    y, aux = apply_moe(p, x, cfg, expert_fn=getattr(dense_fn, "expert", None),
                       per_position=per_position)
    if cfg.dense_residual:
        y = y + apply_mlp(p["dense_mlp"], x, cfg, dense_fn)
    return y, aux
