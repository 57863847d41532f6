"""Sharding rules: Megatron-style TP over the `model` axis, DP over
(`pod`, `data`), ZeRO-1 optimizer-state sharding, sequence-parallel KV
caches for batch-1 long-context decode.

Port of ``repro.runtime.sharding``: the same rules over the port's trees
of tensors (meta tensors at pod sizes: only shapes, dtypes and paths are
read). A spec is the port's own ``P``, a tuple subclass, so it compares
equal to ``tuple`` of the reference's ``PartitionSpec``; ``named`` makes
records of ``NamedSharding(mesh, spec)``. The rules are pure functions of
shapes and axis sizes, reckoned the same on the pod meshes
(``launch.mesh.make_production_mesh``) as on the port's one-card mesh,
where every spec names axes of size 1 and every shard is the whole array.
``local_shape`` gives one device's shard of a shape, what the dry run
counts bytes per device from.

Every rule is divisibility-checked: if a dim does not divide by the mesh
axis size the rule falls back to the next candidate, ending at
replication. This is what lets one rule set serve all 10 architectures
(e.g. arctic's 56 heads are not 16-divisible -> its attention activations
replicate over `model` while its 128 experts and d_ff shard cleanly).
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

from repro_torch.launch.mesh import Mesh


class P(tuple):
    """A partition spec: one entry per leading dim, each None (replicated),
    an axis name, or a tuple of axis names. Trailing dims are
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec bound to the mesh it names axes of."""
    mesh: Mesh
    spec: P


# ------------------------------------------------------------- trees --------

def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *other leaves)`` over nested dicts, lists, tuples
    and NamedTuples; a ``P`` is a leaf. Paths are tuples of dict keys,
    "[i]" for a sequence index and ".name" for a NamedTuple field, as
    ``jax.tree_util`` names them."""
    if isinstance(tree, P):
        return fn(path, tree, *rest)
    if tree is None:                   # an empty subtree, as in jax
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            _map_with_path(fn, v, *(getattr(r, f) for r in rest),
                           path=path + ("." + f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_with_path(fn, v, *(r[i] for r in rest),
                           path=path + (f"[{i}]",))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); a ``P`` is a leaf."""
    return _map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree):
    """[(path string, leaf)] of ``tree``, in its order."""
    out = []
    _map_with_path(lambda p, leaf: out.append(("/".join(p), leaf)), tree)
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


# ------------------------------------------------------------- axes ---------

def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fits(shape, spec, mesh: Mesh) -> bool:
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        if dim % axis_size(mesh, axes) != 0:
            return False
    return len(spec) <= len(shape)


def first_fit(shape, candidates, mesh: Mesh) -> P:
    """First candidate PartitionSpec whose named axes divide the shape."""
    for spec in candidates:
        if _fits(shape, spec, mesh):
            return P(*spec)
    return P()


def local_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of an array of ``shape`` laid out
    by ``spec`` on ``mesh``: each dim divided by the size of the axes its
    entry names (rounded up, as an uneven shard is padded)."""
    out = []
    for i, d in enumerate(shape):
        n = axis_size(mesh, spec[i] if i < len(spec) else None)
        out.append(-(-int(d) // n))
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules. Paths are '/'-joined key paths into the param tree;
# stacked layer params carry a leading layer axis which is never sharded.
# ---------------------------------------------------------------------------

_COL = "col"      # shard output features (column-parallel)
_ROW = "row"      # shard input features (row-parallel)

_PARAM_RULES = [
    # (path regex, kind) — kind decides which dim gets the model axis.
    (r"embed/tok$", "vocab"),
    (r"embed/out$", _COL),
    (r"(attn|xattn)/wq$", _COL),
    (r"(attn|xattn)/wk$", _COL),
    (r"(attn|xattn)/wv$", _COL),
    (r"(attn|xattn)/wo$", _ROW),
    (r"mlp/w_gate$", _COL),
    (r"mlp/w_up$", _COL),
    (r"mlp/w_down$", _ROW),
    (r"moe/router$", "replicate"),
    (r"moe/w_gate$", "expert_col"),
    (r"moe/w_up$", "expert_col"),
    (r"moe/w_down$", "expert_row"),
    (r"moe/dense_mlp/w_gate$", _COL),
    (r"moe/dense_mlp/w_up$", _COL),
    (r"moe/dense_mlp/w_down$", _ROW),
    (r"ssm/in_proj$", _COL),
    (r"ssm/out_proj$", _ROW),
    (r"ssm/conv_w$", "conv"),
    (r"ssm/conv_b$", "vector_model"),
    (r"patch_proj$", _COL),
]


def _spec_for(kind: str, shape, mesh: Mesh, offset: int) -> P:
    """offset = number of leading stacked-layer dims (never sharded)."""
    pad = (None,) * offset
    nd = len(shape) - offset

    def c(*tail):
        return pad + tail

    if kind == "vocab":
        cands = [c("model", None), c(None, "model"), c(None, None)]
    elif kind == _COL:
        cands = [c(None, "model"), c(None, None)]
    elif kind == _ROW:
        cands = [c("model", None), c(None, None)]
    elif kind == "expert_col":      # (E, D, F)
        cands = [c("model", None, None), c(None, None, "model"),
                 c(None, None, None)]
    elif kind == "expert_row":      # (E, F, D)
        cands = [c("model", None, None), c(None, "model", None),
                 c(None, None, None)]
    elif kind == "conv":            # (W, C)
        cands = [c(None, "model"), c(None, None)]
    elif kind == "vector_model":    # (C,)
        cands = [c("model",), c(None,)]
    else:
        cands = [c(*([None] * nd))]
    return first_fit(shape, cands, mesh)


def param_specs(params, mesh: Mesh, fsdp: bool = True,
                fsdp_min_elems: int = 1 << 20):
    """PartitionSpec tree for a param tree (stacked layer dims detected
    from tree position: blocks/enc_blocks/segNN segment stacks carry a
    leading layer axis).

    fsdp=True additionally shards each large tensor's biggest unsharded
    dim over the DP axes (ZeRO-3 / FSDP): the weights are gathered at use.
    Without it, replicated copies of 480B-class params cannot fit a chip.
    """

    def visit(path, leaf):
        pathstr = "/".join(path)
        if pathstr.endswith("/scale"):
            return P()                     # int8 per-filter scales: tiny
        if pathstr.endswith("/q"):
            pathstr = pathstr[:-2]         # int8 payload: weight rules
        # stacked containers contribute leading layer axes
        offset = 0
        if re.search(r"^(blocks|enc_blocks|seg\d+)/", pathstr):
            offset = 1
        shape = _shape(leaf)
        spec = P()
        for pat, kind in _PARAM_RULES:
            if re.search(pat, pathstr):
                spec = _spec_for(kind, shape, mesh, offset)
                break
        if fsdp and len(shape) >= 2 and math.prod(shape) >= fsdp_min_elems:
            spec = zero1_spec(spec, shape, mesh,
                              skip_dims=tuple(range(offset)))
        return spec

    return _map_with_path(visit, params)


def named(specs, mesh: Mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer state additionally sharded over the data axes.
# ---------------------------------------------------------------------------

def zero1_spec(pspec: P, shape, mesh: Mesh, skip_dims=()) -> P:
    """Extend a param spec by sharding the largest unsharded dim over the
    DP axes (classic ZeRO partitioning expressed as a sharding).
    skip_dims: dims never sharded (e.g. the stacked layer axis that a
    layer loop slices every iteration)."""
    dp = dp_axes(mesh)
    shape = tuple(shape)
    if not dp or not shape:
        return pspec
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    used = set()
    for axes in spec:
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            used.add(a)
    if used & set(dp):          # already DP-sharded (e.g. FSDP param spec)
        return P(*spec)
    dpn = axis_size(mesh, dp)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i in skip_dims:
            continue
        if spec[i] is None and shape[i] % dpn == 0:
            spec[i] = dp if len(dp) > 1 else dp[0]
            return P(*spec)
    return pspec


def opt_state_specs(params, pspecs, mesh: Mesh):
    return tree_map(lambda p, s: zero1_spec(s, _shape(p), mesh),
                    params, pspecs)


# ---------------------------------------------------------------------------
# Batch / activation / cache rules
# ---------------------------------------------------------------------------

def batch_specs(batch_tree, mesh: Mesh):
    """Shard the leading batch dim over (pod, data); fall back seq-dim
    sharding over `data` for batch-1 long-context inputs."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)

    def visit(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        if shape[0] % axis_size(mesh, dpa) == 0:
            return P(dpa)
        if len(shape) >= 2 and shape[1] % mesh.shape.get("data", 1) == 0:
            return P(None, "data")
        return P()

    return tree_map(visit, batch_tree)


def cache_specs(cache_tree, cfg, mesh: Mesh):
    """KV/SSM cache sharding for decode.

    Layout reminders: attn k/v (L, B, A, Hkv, hd); ssm conv
    (L, B, W-1, C), ssm state (L, B, H, Pd, N) — uniform across segments
    (hybrid segments use the same per-segment layouts).
    Batch shards over DP when divisible; otherwise (long_500k, B=1) the
    cache SEQUENCE dim shards over `data` (sequence-parallel decode) and
    SSM state heads shard over `data`. KV heads shard over `model` when
    divisible.
    """
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    dpn = axis_size(mesh, dpa)

    def visit(path, leaf):
        pathstr = "/".join(path)
        shape = _shape(leaf)
        ndim = len(shape)
        if not shape or ndim <= 1:
            return P()
        if pathstr.endswith("/k") or pathstr.endswith("/v"):
            L, B, A, H, hd = shape
            spec = [None, None, None, None, None]
            if B % dpn == 0:
                spec[1] = dpa
            elif A % mesh.shape.get("data", 1) == 0:
                spec[2] = "data"
            if H % mesh.shape.get("model", 1) == 0:
                spec[3] = "model"
            # NOTE: when kv-heads < model axis the cache REPLICATES over
            # `model`. Sharding the seq dim instead was tried and REFUTED:
            # the dynamic-index cache update scatter cannot be partitioned
            # along the sharded dim, so GSPMD all-gathers the whole cache
            # every token (qwen decode collective 0.19s -> 1.55s). The
            # production fix is KV replication to the TP degree or a
            # shard_map decode kernel (EXPERIMENTS.md §Perf iter 4).
            return P(*spec)
        if pathstr.endswith("/pk") or pathstr.endswith("/pv"):
            # paged KV pool (L, n_pages, page_size, Hkv, hd): no batch
            # dim to DP-shard (pages are the unit of occupancy, owned by
            # whichever slot the host table says); kv-heads shard over
            # `model` exactly like the contiguous cache, everything else
            # replicates — the page-id gather must stay local
            L, NP_, PS_, H, hd = shape
            spec = [None, None, None, None, None]
            if H % mesh.shape.get("model", 1) == 0:
                spec[3] = "model"
            return P(*spec)
        if "ssm/state" in pathstr or pathstr.endswith("state"):
            B_idx = ndim - 4
            spec = [None] * ndim
            if shape[B_idx] % dpn == 0:
                spec[B_idx] = dpa
            if shape[B_idx + 1] % mesh.shape.get("model", 1) == 0:
                spec[B_idx + 1] = "model"
            return P(*spec)
        if "conv" in pathstr:
            B_idx = ndim - 3
            spec = [None] * ndim
            if shape[B_idx] % dpn == 0:
                spec[B_idx] = dpa
            if shape[-1] % mesh.shape.get("model", 1) == 0:
                spec[-1] = "model"
            return P(*spec)
        if "enc_out" in pathstr:
            spec = [None] * ndim
            if shape[0] % dpn == 0:
                spec[0] = dpa
            return P(*spec)
        return P()

    return _map_with_path(visit, cache_tree)


# ---------------------------------------------------------------------------
# Checks and bytes on one device
# ---------------------------------------------------------------------------

def check_fits(tree, specs, mesh: Mesh, what: str = "operand"):
    """Raise ValueError unless every spec of ``specs`` names axes of
    ``mesh`` that divide its leaf's dims."""
    def visit(path, leaf, spec):
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        missing = [a for a in axes if a not in mesh.shape]
        if missing or not _fits(_shape(leaf), spec, mesh):
            raise ValueError(f"{what} {'/'.join(path) or '<leaf>'} "
                             f"{_shape(leaf)}: spec {spec} does not fit "
                             f"mesh {mesh.shape}")
    _map_with_path(visit, tree, specs)


def local_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    total = []
    tree_map(lambda leaf, spec: total.append(
        math.prod(local_shape(_shape(leaf), spec, mesh))
        * leaf.dtype.itemsize), tree, specs)
    return sum(total)
