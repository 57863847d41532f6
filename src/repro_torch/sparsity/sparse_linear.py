"""DB-PIM sparsity on the model's projections: compression artifacts, the
cost model's view of them, per-layer kernel tables, stacked serving
tables and the in-step INT8 serving format.

Port of ``repro.sparsity.sparse_linear``:

  * ``sparsify_params`` compresses every eligible projection (``ELIGIBLE``:
    attention q/k/v/o, MLP gate/up/down, MoE experts and arctic's dense
    residual MLP, SSM in/out) with the paper's pipeline, 1 x alpha block
    pruning then FTA on one INT8 scale per matrix, a stacked (L, K, N)
    leaf slice by slice; ``dequant_tree`` rebuilds the FTA-compliant float
    weights so the same model code runs the compressed model; and
    ``pim_speedup_estimate`` maps the projections onto the DB-PIM cost
    model (``core.pim_model``). Artifacts are tensors on the params'
    device; the cost model reads numpy copies of one slice each;
  * ``quantize_params_for_serving`` / ``dequant_params_for_serving``: the
    lock-step "serve" step's format (``launch.steps``), projections INT8
    with one scale per filter, dequantized inside the step;
  * per layer: ``pack_projection`` / ``build_kernel_tables`` compile named
    2D projections for one kernel mode, and ``kernel_dense_fn`` is the
    ``dense_fn(w, x, name)`` hook that serves them through the value
    (``block_sparse_matmul``), bit (``fta_int8_matmul``) or joint
    (``joint_sparse_matmul``) kernel, with the reference's dispatch rules;
  * stacked: ALL L layers of every projection family packed with one
    shared MAXB. JAX passes the stacked arrays to ``lax.scan`` as xs; here
    the Python layer loop slices layer ``l`` of every table and rebuilds
    the hook from the slices, so the joint kernel serves every projection
    of every layer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.segments import (decoder_layout,
                                         packable_projections,
                                         projection_param_path)

#: Kernel dispatch modes for compressed projections. "value" skips pruned
#: weight blocks (block_sparse_matmul), "bit" serves FTA/INT8 weights
#: (fta_int8_matmul), "joint" fuses both in one kernel
#: (joint_sparse_matmul), the paper's headline configuration.
KERNEL_MODES = ("dense", "value", "bit", "joint")

ELIGIBLE = re.compile(
    r"(attn|xattn)/(wq|wk|wv|wo)$|mlp/w_(gate|up|down)$|"
    r"moe/w_(gate|up|down)$|moe/dense_mlp/w_(gate|up|down)$|"
    r"ssm/(in_proj|out_proj)$")


# ---------------------------------------------------------------------------
# Compression artifacts and the DB-PIM cost model's view of them
# ---------------------------------------------------------------------------

@dataclass
class DBPIMCompressed:
    """Compressed weight artifacts + per-tensor sparsity metadata."""
    tensors: Dict[str, dict] = field(default_factory=dict)
    report: Dict[str, dict] = field(default_factory=dict)


def _key(path) -> str:
    """'blocks/attn/wq' from a key path (a tuple of dict keys)."""
    return "/".join(str(k) for k in path)


def _flatten_with_path(tree, path=()):
    """(key path, leaf) of a nested dict in the JAX package's flattening
    order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _on_device(value: float, like):
    """``value`` as a 0-dim tensor on ``like``'s device and dtype. Dividing
    a CUDA tensor by a Python number multiplies by its reciprocal, which
    can miss the correctly rounded quotient by an ulp; by a device tensor
    it divides, as the host does."""
    return like.new_tensor(value)


def _compress_2d(w2, value_sparsity: float, alpha: int):
    """One (K, N) float32 matrix: N padded with zeros to a multiple of
    alpha, 1 x alpha block pruning (``core.pruning``), ONE INT8 scale for
    the whole matrix (max|w| / 127), round half to even, then FTA under
    the mask. Returns (q_fta int32, scale float, mask int32, phi_th int32,
    pad), on w2's device; float32 throughout, as the reference's numpy."""
    from repro_torch.core import fta, pruning
    K, N = w2.shape
    pad = (-N) % alpha
    if pad:
        w2 = torch.nn.functional.pad(w2, (0, pad))
    mask = pruning.block_prune_mask(w2, value_sparsity, alpha)
    amax = w2.abs().max() + 1e-12
    scale = amax / _on_device(127.0, amax)
    q = torch.clamp(torch.round(w2 / scale), -127, 127).to(torch.int32)
    q_fta, phi = fta.fta_quantize(q, mask)
    return q_fta, float(scale), mask, phi, pad


def sparsify_params(params, cfg: ModelConfig,
                    value_sparsity: Optional[float] = None,
                    alpha: int = 8) -> DBPIMCompressed:
    """Compress every ``ELIGIBLE`` projection of ``params`` slice by slice
    (``_compress_2d``; a stacked (L, K, N) or (L, E, K, N) leaf is L or L *
    E matrices) at ``value_sparsity`` (default cfg.dbpim_value_sparsity).
    ``tensors[key]``: "q" int8 and "mask" int8 (the leaf's shape, N padded
    to alpha), "scale" float32 (one per slice), "pad", "orig_shape",
    "dtype". ``report[key]``: the first slice's value and bit sparsity,
    phi histogram, and the INT8 and original byte counts. Routers, norms
    and embeddings stay dense."""
    from repro_torch.core import fta
    from repro_torch.core.pim_model import sparsity_from_export
    vs = cfg.dbpim_value_sparsity if value_sparsity is None else value_sparsity
    out = DBPIMCompressed()
    for path, leaf in _flatten_with_path(params):
        key = _key(path)
        if not ELIGIBLE.search(key) or leaf.ndim < 2:
            continue
        arr = leaf.float()
        lead = tuple(arr.shape[:-2])
        arr2 = arr.reshape((-1,) + tuple(arr.shape[-2:]))
        qs, masks, phis, scales = [], [], [], []
        pad = 0
        for l in range(arr2.shape[0]):
            q, scale, mask, phi, pad = _compress_2d(arr2[l], vs, alpha)
            qs.append(q)
            masks.append(mask)
            phis.append(phi)
            scales.append(scale)
        q_all = torch.stack(qs).reshape(lead + tuple(qs[0].shape))
        mask_all = torch.stack(masks).reshape(lead + tuple(masks[0].shape))
        out.tensors[key] = {
            "q": q_all.to(torch.int8),
            "scale": torch.tensor(scales, dtype=torch.float32,
                                  device=leaf.device),
            "mask": mask_all.to(torch.int8), "pad": pad,
            "orig_shape": tuple(arr.shape), "dtype": _dtype_name(leaf.dtype),
        }
        q0, m0 = qs[0].cpu().numpy(), masks[0].cpu().numpy()
        sp = sparsity_from_export(q0 * m0, m0, phis[0].cpu().numpy())
        out.report[key] = {
            "value_sparsity": sp.value_sparsity,
            "bit_sparsity": fta.achieved_bit_sparsity(qs[0], masks[0]),
            "phi_hist": sp.phi_hist,
            "int8_bytes": int(q_all.numel()),
            "orig_bytes": int(arr.numel() * (2 if leaf.dtype == torch.bfloat16
                                             else 4)),
        }
    return out


def dequant_tree(params, comp: DBPIMCompressed):
    """``params`` with every compressed leaf replaced by its FTA-compliant
    reconstruction q * scale (float32, padding cut, cast to the leaf's
    dtype)."""
    def visit(path, leaf):
        t = comp.tensors.get(path)
        if t is None:
            return leaf
        q = t["q"].reshape((-1,) + tuple(t["q"].shape[-2:])).float()
        w = q * t["scale"].reshape(-1, 1, 1)
        if t["pad"]:
            w = w[:, :, :-t["pad"]]
        return w.reshape(t["orig_shape"]).to(leaf.dtype)
    return _map_with_path(visit, params)


def pim_speedup_estimate(comp: DBPIMCompressed, cfg: ModelConfig,
                         tokens: int = 64):
    """Map the compressed projections onto the DB-PIM cost model: speedup,
    energy savings and U_act of running this LM's projections (``tokens``
    rows each) on the paper's chip against its dense digital-PIM baseline.
    Each projection's sparsity is read from its first slice (layer 0), as
    in the reference."""
    from repro_torch.core import fta
    from repro_torch.core.pim_model import (LayerGEMM,
                                            evaluate_dense_baseline,
                                            evaluate_model,
                                            sparsity_from_export)
    layers, sps = [], {}
    for key, t in comp.tensors.items():
        q2 = t["q"].reshape((-1,) + tuple(t["q"].shape[-2:]))
        mask2 = t["mask"].reshape((-1,) + tuple(t["mask"].shape[-2:]))
        K, N = q2.shape[-2:]
        layers.append(LayerGEMM(key, M=tokens, K=K, N=N, kind="fc"))
        q0, m0 = q2[0].to(torch.int32), mask2[0].to(torch.int32)
        phi = fta.compute_thresholds(q0, m0)
        sps[key] = sparsity_from_export(q0.cpu().numpy(), m0.cpu().numpy(),
                                        phi.cpu().numpy())
    ours = evaluate_model(layers, sps, use_input_bit=False)
    dense = evaluate_dense_baseline(layers)
    return {
        "speedup": dense.cycles / ours.cycles,
        "energy_savings": 1 - ours.energy_pj / dense.energy_pj,
        "u_act": ours.u_act,
        "n_projections": len(layers),
    }


# ---------------------------------------------------------------------------
# Per-layer kernel-mode dispatch: pack projections once, then intercept the
# model's matmuls (the dense_fn hook of apply_mlp / attention) with the
# kernel of the mode.
# ---------------------------------------------------------------------------

def pack_projection(w2, mode: str, value_sparsity: float = 0.6) -> dict:
    """Compile one (K, N) projection into the artifact for ``mode``, on its
    device. Value pruning is tile-granular (``ops.tile_prune_mask``), the
    unit the kernels skip. The artifact kind is the reference's: "value"
    and "bit" when the shape divides the kernel's tiles, else "value_ref"
    and "bit_ref" (same math, plain torch); "joint" pads internally."""
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import ops
    if mode not in KERNEL_MODES:
        raise ValueError(f"mode {mode!r} not in {KERNEL_MODES}")
    w = torch.as_tensor(w2).float()
    K, N = w.shape
    if mode == "dense":
        return {"kind": "dense"}
    if mode == "joint":
        return {"kind": "joint",
                "packed": ops.pack_joint_sparse(
                    w, value_sparsity=value_sparsity)}
    if mode == "value":
        mask = ops.tile_prune_mask(w, value_sparsity, bsk.BK, bsk.BN)
        art = {"kind": "value_ref", "w": w * mask}
        if K % bsk.BK == 0 and N % bsk.BN == 0:
            w_blocks, idx = ops.pack_block_sparse(w * mask,
                                                  torch.ones_like(mask))
            art.update(kind="value", w_blocks=w_blocks, idx=idx)
        return art
    # "bit": per-filter INT8 scale + FTA projection, dense layout (no value
    # pruning; the quantization step of the joint pack)
    q, scales = ops.quantize_int8_fta(w, torch.ones_like(w, dtype=torch.int32))
    kind = "bit" if (K % ftk.BK == 0 and N % ftk.BN == 0) else "bit_ref"
    return {"kind": kind, "q": q.to(torch.int8), "scales": scales}


def build_kernel_tables(named_weights: Dict[str, torch.Tensor],
                        cfg: Optional[ModelConfig] = None,
                        mode: Optional[str] = None,
                        value_sparsity: Optional[float] = None,
                        ) -> Dict[str, dict]:
    """Pack every named 2D projection for the configured kernel mode."""
    mode = mode or (cfg.dbpim_mode if cfg is not None else "joint")
    vs = value_sparsity if value_sparsity is not None else \
        (cfg.dbpim_value_sparsity if cfg is not None else 0.6)
    return {name: pack_projection(w, mode, vs)
            for name, w in named_weights.items()}


def kernel_dense_fn(tables: Dict[str, dict]):
    """The dense_fn(w, x, name) hook for apply_mlp / attention.

    Projections found in ``tables`` run on their artifact; anything else
    stays a plain matmul. As in the reference, the value and bit kernels
    serve only activation batches whose rows are a multiple of the TPU
    kernels' 128-row tile, and other batches take the reference's plain
    math (which for "bit" does not round x to bf16)."""
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import ops

    def mm(w, x, name):
        t = tables.get(name)
        if t is None or t["kind"] == "dense":
            return x @ w
        rows = x.numel() // x.shape[-1]
        if t["kind"] == "joint":
            return ops.joint_dense(x, t["packed"]).to(x.dtype)
        if t["kind"] == "value" and rows % bsk.BM == 0:
            return ops.sparse_dense(x, t["w_blocks"].to(x.dtype), t["idx"])
        if t["kind"] in ("value", "value_ref"):
            return x @ t["w"].to(x.dtype)
        if t["kind"] == "bit" and rows % ftk.BM == 0:
            return ops.fta_dense(x, t["q"], t["scales"]).to(x.dtype)
        # bit_ref / ragged-row bit: the same INT8 x scale math, plain
        wd = t["q"].float() * t["scales"]
        return (x.float() @ wd).to(x.dtype)

    return mm


def _map_with_path(fn, tree, prefix=""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict, with the
    '/'-joined key path the JAX package's tree_map_with_path gives."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


@dataclass
class StackedKernelTables:
    """Joint-sparse weights for a whole layer stack. ``arrays`` maps hook
    name -> {"w_blocks", "idx", "scales", "nblocks"} stacked tensors
    (leading axis = layer; grouped ``moe/*`` entries carry the expert axis
    second); ``static`` the per-projection (k, n, k_pad)."""
    arrays: Dict[str, Dict[str, torch.Tensor]]
    static: Dict[str, Tuple[int, int, int]]

    def dense_fn(self, slices):
        """The dense_fn(w, x, name) hook from one layer's slices
        (``models.transformer.layer_slice`` of ``arrays``): packed
        projections run ``ops.joint_dense``, the rest stay plain matmuls.
        Its ``expert(w, x, name)`` attribute is the grouped form that
        ``models.moe`` routes the expert contractions through: x (..., E,
        C, K) -> (..., E, C, N), one ``joint_dense`` per packed expert
        slice, stacked on axis -3; the plain einsum with ``w`` (E, K, N)
        when ``name`` is not packed."""
        from repro_torch.kernels import ops

        def _packed(t, name, e=None):
            k, n, k_pad = self.static[name]
            a = t if e is None else {key: arr[e] for key, arr in t.items()}
            return ops.JointPacked(a["w_blocks"], a["idx"], a["scales"],
                                   a["nblocks"], k, n, k_pad)

        def mm(w, x, name):
            t = None if slices is None else slices.get(name)
            if t is None:
                return x @ w
            return ops.joint_dense(x, _packed(t, name)).to(x.dtype)

        def expert(w, x, name):
            t = None if slices is None else slices.get(name)
            if t is None:
                return torch.einsum("...eck,ekf->...ecf", x, w)
            E = t["w_blocks"].shape[0]
            return torch.stack(
                [ops.joint_dense(x[..., e, :, :], _packed(t, name, e)
                                 ).to(x.dtype) for e in range(E)], dim=-3)

        mm.expert = expert
        return mm


@dataclass
class SegmentedKernelTables:
    """Per-segment stacked packs for a whole decoder (models.segments
    layout). ``arrays`` / ``static`` give the flat view: a single "blocks"
    segment passes through unprefixed, multi-segment stacks prefix keys
    with the segment name."""
    segments: Dict[str, StackedKernelTables]

    @property
    def arrays(self) -> Dict[str, Dict[str, torch.Tensor]]:
        if set(self.segments) == {"blocks"}:
            return self.segments["blocks"].arrays
        return {f"{s}/{name}": t for s, seg in self.segments.items()
                for name, t in seg.arrays.items()}

    @property
    def static(self) -> Dict[str, Tuple[int, int, int]]:
        if set(self.segments) == {"blocks"}:
            return self.segments["blocks"].static
        return {f"{s}/{name}": t for s, seg in self.segments.items()
                for name, t in seg.static.items()}


def _proj_subpath(seg, name: str) -> str:
    """Param subpath of a hook name within one segment's block tree."""
    return projection_param_path(seg, name)[len(seg.name) + 1:]


def _stacked_projections(params, cfg: ModelConfig):
    """segment name -> {hook name -> stacked weight: (L, K, N), or (L, E,
    K, N) for the grouped ``moe/*`` experts}; None when the param tree
    does not carry the stacked segment subtrees."""
    out = {}
    for seg in decoder_layout(cfg):
        blk = params.get(seg.name)
        if blk is None:
            return None
        projs = {}
        for name in packable_projections(seg, cfg):
            node = blk
            for part in _proj_subpath(seg, name).split("/"):
                node = node.get(part) if isinstance(node, dict) else None
                if node is None:
                    break
            if node is None:
                continue        # e.g. a gelu MLP has no w_gate
            projs[name] = node
        out[seg.name] = projs
    return out


def _pack_settings(cfg: ModelConfig, mode, value_sparsity):
    """(value sparsity, payload) of a stacked pack in ``mode``, or None for
    "dense". "joint" packs at cfg.dbpim_value_sparsity (INT8/FTA
    payload); "bit" the same layout at zero value sparsity; "value" the
    bf16-payload layout."""
    mode = mode or (cfg.dbpim_mode if cfg.dbpim else "dense")
    if mode not in KERNEL_MODES:
        raise ValueError(f"mode {mode!r} not in {KERNEL_MODES}")
    if mode == "dense":
        return None
    if mode == "bit":
        vs = 0.0
    else:
        vs = value_sparsity if value_sparsity is not None else \
            cfg.dbpim_value_sparsity
    return vs, ("bf16" if mode == "value" else "int8")


def _tile_dims(K: int, N: int, bk, bn):
    """bk/bn default to the kernel tile, clamped down to the projection
    dims rounded up to a multiple of 8, so reduced configs (d_model < 128)
    do not pack pure padding."""
    def round8(d):
        return max(8, 8 * (-(-d // 8)))
    from repro_torch.kernels import ops
    return (bk if bk is not None else min(ops.BK, round8(K)),
            bn if bn is not None else min(ops.BN, round8(N)))


def _pack_stack(w, vs, payload, bk, bn):
    """One projection family packed: (arrays entry, (k, n, k_pad)). A
    rank-4 (L, E, K, N) stack of experts packs grouped."""
    from repro_torch.kernels import ops
    bk, bn = _tile_dims(w.shape[-2], w.shape[-1], bk, bn)
    pack = (ops.pack_joint_sparse_grouped if w.ndim == 4
            else ops.pack_joint_sparse_stacked)
    p = pack(w, value_sparsity=vs or None, bk=bk, bn=bn, payload=payload)
    return ({"w_blocks": p.w_blocks, "idx": p.idx, "scales": p.scales,
             "nblocks": p.nblocks}, (p.k, p.n, p.k_pad))


def build_stacked_tables(params, cfg: ModelConfig,
                         mode: Optional[str] = None,
                         value_sparsity: Optional[float] = None,
                         bk: Optional[int] = None, bn: Optional[int] = None,
                         ) -> Optional[SegmentedKernelTables]:
    """Pack every stacked projection of ``params`` for serving, per decoder
    segment, on the device the params lie on: "joint" at
    cfg.dbpim_value_sparsity (INT8/FTA payload), "bit" the same layout at
    zero value sparsity, "value" the bf16-payload layout; "dense" returns
    None. MoE expert stacks (L, E, K, N) pack grouped: one MAXB over every
    (layer, expert) slice."""
    settings = _pack_settings(cfg, mode, value_sparsity)
    if settings is None:
        return None
    vs, payload = settings
    by_segment = _stacked_projections(params, cfg)
    if by_segment is None:
        return None
    segments: Dict[str, StackedKernelTables] = {}
    for seg_name, projections in by_segment.items():
        arrays, static = {}, {}
        for name, w in projections.items():
            arrays[name], static[name] = _pack_stack(w, vs, payload, bk, bn)
        segments[seg_name] = StackedKernelTables(arrays=arrays, static=static)
    return SegmentedKernelTables(segments=segments)


def init_stacked_serving(cfg: ModelConfig, seed: int = 0, device="cuda",
                         mode: Optional[str] = None,
                         value_sparsity: Optional[float] = None,
                         bk: Optional[int] = None, bn: Optional[int] = None):
    """``(strip_packed_projections(params), build_stacked_tables(params,
    ...))`` of ``params = models.init_params(cfg, seed, device)``, byte
    for byte, without ever holding a whole dense expert stack: the MoE
    init draws each expert stack one (layer, expert) slice at a time, and
    here each slice is packed into preallocated (L, E, NT, MAXB, bk, bn)
    tables as it is drawn, and dropped. MAXB comes from the shape
    (``ops.balanced_maxb``: balanced pruning, no explicit masks). Every
    other leaf is drawn as ``init_params`` draws it, and the other
    projection stacks pack as in ``build_stacked_tables``. A mixtral-8x7b
    build holds the packs, the non-expert weights and one expert slice.
    "dense" returns (params, None)."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    settings = _pack_settings(cfg, mode, value_sparsity)
    if settings is None:
        return init_params(cfg, seed=seed, device=device), None
    vs, payload = settings
    grouped: Dict[str, Dict[str, torch.Tensor]] = {}
    static: Dict[str, Tuple[int, int, int]] = {}

    def sink(seg, name, l, e, w):
        """Pack slice (l, e) of ``seg``'s expert projection ``name`` into
        its (L, E, ...) tables, made at its first slice."""
        bk_, bn_ = _tile_dims(*w.shape, bk, bn)
        p = ops.pack_joint_sparse_balanced(
            w, ops.balanced_maxb(w.shape[0], vs, bk_), bk=bk_, bn=bn_,
            value_sparsity=vs or None, payload=payload)
        key = (seg.name, name)
        if key not in grouped:
            grouped[key] = {
                f: torch.empty((seg.length, cfg.n_experts)
                               + tuple(getattr(p, f).shape),
                               dtype=getattr(p, f).dtype, device=w.device)
                for f in ("w_blocks", "idx", "scales", "nblocks")}
            static[key] = (p.k, p.n, p.k_pad)
        for f, t in grouped[key].items():
            t[l, e] = getattr(p, f)

    params = init_params(cfg, seed=seed, device=device, expert_sink=sink)
    by_segment = _stacked_projections(params, cfg)
    segments: Dict[str, StackedKernelTables] = {}
    for seg in decoder_layout(cfg):
        arrays, stat = {}, {}
        for name, w in by_segment[seg.name].items():
            if (seg.name, name) in grouped:
                arrays[name] = grouped[(seg.name, name)]
                stat[name] = static[(seg.name, name)]
            else:
                arrays[name], stat[name] = _pack_stack(w, vs, payload, bk,
                                                       bn)
        segments[seg.name] = StackedKernelTables(arrays=arrays, static=stat)
    return (strip_packed_projections(params, cfg),
            SegmentedKernelTables(segments=segments))


def _packed_param_paths(cfg: ModelConfig):
    """Exact '/'-joined param paths of every packable projection."""
    return {projection_param_path(seg, name)
            for seg in decoder_layout(cfg)
            for name in packable_projections(seg, cfg)}


def strip_packed_projections(params, cfg: ModelConfig):
    """Replace every stacked-packed projection with a (L, 1, 1) zero
    placeholder: the tables serve those matmuls, so the dense copies need
    not stay on the device. The dense_fn hook never reads the weight it
    intercepts."""
    if _stacked_projections(params, cfg) is None:
        return params
    paths = _packed_param_paths(cfg)

    def visit(path, leaf):
        if path in paths:
            return torch.zeros((leaf.shape[0], 1, 1), dtype=leaf.dtype,
                               device=leaf.device)
        return leaf
    return _map_with_path(visit, params)


def reconstruct_stacked_params(params, tables: SegmentedKernelTables, cfg):
    """Dense FTA reference weights: each packed projection in ``params``
    replaced by its unpacked (pruned + dequantized) stack, grouped expert
    stacks included, so the plain matmul path reproduces what the joint
    kernels compute."""
    from repro_torch.kernels import ops

    segs = {s.name: s for s in decoder_layout(cfg)}
    recon = {}
    for seg_name, seg_tables in tables.segments.items():
        for name, t in seg_tables.arrays.items():
            k, n, k_pad = seg_tables.static[name]
            fields = (t["w_blocks"], t["idx"], t["scales"], t["nblocks"],
                      k, n, k_pad)
            if t["w_blocks"].ndim == 6:         # grouped (L, E, ...) experts
                dense = ops.unpack_joint_sparse_grouped(
                    ops.JointPackedGrouped(*fields))
            else:
                dense = ops.unpack_joint_sparse_stacked(
                    ops.JointPackedStacked(*fields))
            recon[projection_param_path(segs[seg_name], name)] = dense

    def visit(path, leaf):
        dense = recon.get(path)
        return leaf if dense is None else dense.to(leaf.dtype)
    return _map_with_path(visit, params)


# ---------------------------------------------------------------------------
# In-step INT8 weight serving: projections stored INT8 with a per-filter
# scale, dequantized inside the lock-step "serve" step (launch.steps).
# ---------------------------------------------------------------------------

def quantize_params_for_serving(params):
    """Eligible projection leaves -> {"q": int8, "scale": float32 (..., 1,
    N)}, one symmetric scale per filter (max|w| over K / 127 + 1e-12,
    round half to even); every other leaf as it is."""
    def visit(path, leaf):
        if not ELIGIBLE.search(path) or leaf.ndim < 2:
            return leaf
        wf = leaf.float()
        amax = wf.abs().amax(dim=-2, keepdim=True)
        scale = amax / _on_device(127.0, amax) + 1e-12
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    return _map_with_path(visit, params)


def dequant_params_for_serving(qparams, dtype=torch.bfloat16):
    """Inverse of ``quantize_params_for_serving``: every {"q", "scale"}
    node -> (q * scale) in float32, cast to ``dtype``."""
    if isinstance(qparams, dict):
        if set(qparams) == {"q", "scale"}:
            return (qparams["q"].float() * qparams["scale"]).to(dtype)
        return {k: dequant_params_for_serving(v, dtype)
                for k, v in qparams.items()}
    return qparams
