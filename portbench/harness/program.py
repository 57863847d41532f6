"""The system under test, built from the benchmark's seeded slices.

``build(spec, seed, device)`` makes the parameter tree the port's serving
engine reads and hands every projection to the port's own packing entry
points: the attention and MLP stacks to
``sparse_linear.build_stacked_tables``, each MoE expert slice, one at a
time, to ``ops.pack_joint_sparse_balanced`` at the stack's shared MAXB,
as the port's own slice-by-slice build does. The dense copies are then
stripped, so a mixtral-8x7b holds its packs, its non-expert weights and
one expert slice at a time.
"""

from __future__ import annotations

import torch

from portbench.reference import slices

#: the ModelConfig fields a configuration file may set
CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
                 "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                 "norm_type", "rope_theta", "rope_pct", "n_experts", "top_k",
                 "capacity_factor", "window", "mlp_type", "dtype",
                 "dbpim_value_sparsity", "dbpim_mode")


def model_config(spec: dict):
    from repro_torch.models.config import ModelConfig
    kw = {k: spec[k] for k in CONFIG_FIELDS if k in spec}
    return ModelConfig(dbpim=True, **kw)


def _stack(fn, L):
    return torch.stack([fn(l) for l in range(L)])


def build(spec: dict, seed: int, device):
    """(cfg, params, tables) of one configuration, weights from ``seed``."""
    from repro_torch.kernels import ops
    from repro_torch.models.segments import decoder_layout
    from repro_torch.sparsity import sparse_linear as sl

    cfg = model_config(spec)
    (seg,) = decoder_layout(cfg)
    L = cfg.n_layers
    vs, payload = sl._pack_settings(cfg, None, None)

    def norms(name):
        parts = [slices.norm(spec, seed, name, device, l) for l in range(L)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    blk = {"norm1": norms("norm1"), "norm2": norms("norm2"), "attn": {}}
    for name in ("wq", "wk", "wv", "wo"):
        blk["attn"][name] = _stack(
            lambda l: slices.weight(spec, seed, f"attn/{name}", l, device), L)
    moe = bool(cfg.n_experts)
    if moe:
        blk["moe"] = {"router": _stack(
            lambda l: slices.router(spec, seed, l, device), L)}
    else:
        blk["mlp"] = {name: _stack(
            lambda l: slices.weight(spec, seed, f"mlp/{name}", l, device), L)
            for name in ("w_gate", "w_up", "w_down")}
    params = {"embed": slices.embeddings(spec, seed, device),
              "final_norm": slices.norm(spec, seed, "final_norm", device),
              seg.name: blk}
    tables = sl.build_stacked_tables(params, cfg)
    params = sl.strip_packed_projections(params, cfg)
    if moe:
        st = tables.segments[seg.name]
        for name in ("w_gate", "w_up", "w_down"):
            key = f"moe/{name}"
            grouped = None
            for l in range(L):
                for e in range(cfg.n_experts):
                    w = slices.weight(spec, seed, key, l, device, e)
                    bk, bn = sl._tile_dims(*w.shape, None, None)
                    p = ops.pack_joint_sparse_balanced(
                        w, ops.balanced_maxb(w.shape[0], vs, bk), bk=bk,
                        bn=bn, value_sparsity=vs or None, payload=payload)
                    if grouped is None:
                        grouped = {f: torch.empty(
                            (L, cfg.n_experts) + tuple(getattr(p, f).shape),
                            dtype=getattr(p, f).dtype, device=device)
                            for f in ("w_blocks", "idx", "scales",
                                      "nblocks")}
                        st.static[key] = (p.k, p.n, p.k_pad)
                    for f, t in grouped.items():
                        t[l, e] = getattr(p, f)
                    del w, p
            st.arrays[key] = grouped
            blk = params[seg.name]["moe"]
            blk[name] = torch.zeros((L, 1, 1), dtype=slices.dtype_of(spec),
                                    device=device)
    return cfg, params, tables


def table_bytes(tables) -> int:
    return sum(a.numel() * a.element_size()
               for t in tables.arrays.values() for a in t.values())
