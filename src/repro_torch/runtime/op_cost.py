"""Op-level cost accounting of one call of a step: FLOPs, bytes, and the
per-parameter-path weight traffic the decode roofline term reads.

Port of ``repro.runtime.jaxpr_cost``, with the same public names, result
keys and row labels, so the two packages' records read alike. Where the
reference walks a traced jaxpr, this module runs the step itself under a
``TorchDispatchMode`` on meta copies of its arguments: every aten op the
step issues passes through the mode and is charged by the reference
walker's rules, nothing is launched, no device memory is allocated, and
the caller's tensors are left bitwise as they were (the in-place steps
write into the meta copies). The port's Python loop over layers replaces
``scan``'s trip multiplier: each layer slice is charged when it is read.

Rules, per op (the counterparts of the reference's ``_walk``):

  * PROVENANCE. ``analyze(fn, *args)`` tags every tensor leaf of the
    arguments named by ``weight_argnums`` (default: arg 0, the params) with
    its path ("blocks/attn/wq"), and ``const_weights`` tags tensors the
    step closes over ("tables/wq/w_blocks"), by identity. A tag passes
    through views and copies (select, slice, view, t, permute, expand,
    clone, ...) and through dtype converts, as the reference's structural
    primitives pass it; any op that computes drops it.
  * DTYPE CONVERTS (``_to_copy``) record their source, as ``convert_src``
    does, and are charged nothing: a product whose operand is a fresh
    convert charges the source's bytes.
  * PRODUCTS (mm, bmm, addmm, baddbmm) are charged as ``dot_general``:
    ``2 * prod(out) * K`` flops, operand and result bytes, weight bytes for
    each tagged operand at its convert source's size, else, for a rank-2
    rhs with no batch, into ``UNTAGGED_DOT``. An operand broadcast over a
    dim (stride 0: ``torch.matmul`` expands a weight to feed ``bmm``) is
    charged the bytes it holds, once. A product autograd issues in a
    backward pass charges nothing to ``UNTAGGED_DOT``: its untagged
    operands are gradients (a weight's gradient ``x^T @ dy``), which the
    reference contracts over the batch dims of rank-3 operands and does
    not charge.
  * DATA MOVEMENT (gathers, scatters, index ops, sort, cumsum) charges
    operand and result bytes. Every op but a convert adds prod(out) flops.
  * KERNELS. The port's hand-written kernels are ctypes calls that no
    dispatch mode sees. A wrapper given meta tensors while this thread's
    ``analyze`` runs (``recording(*operands)``) reports its call through
    ``kernel`` (the four DB-PIM kernels, the counterparts of one
    ``pallas_call`` each: their flops go to ``pallas_flops`` and their
    integer, (1, N) and rank != 2 float operands to the weight rows) or
    ``charge_ops`` (``row_attention`` and ``row_norm``, which replace plain
    einsums and norm ops in the reference), and returns an empty meta
    tensor of its output's shape without reaching the kernel or its plain
    version. A tensor on any other device reaching a wrapper then is
    refused, so no call on the card or the host can skip its kernel.

``weight_bytes_by_path`` attributes every byte charged into
``weight_bytes`` to a row, charged at the same site with the same integer
value, so the rows sum to ``weight_bytes`` exactly.

What describes the port: ``weight_bytes`` and its rows are the bytes of
stored weights the port's step reads, and bound its decode call from
below. ``pallas_flops``, ``dot_flops``, ``flops`` and ``bytes`` count
the reference's work, kept for parity with its records: the joint kernel
is charged at the reference's padded M (16 rows for a 4-row bf16 decode,
four times the port kernel's arithmetic), ``row_attention`` over the
whole key span, and ``flops`` also counts the empty outputs the hooks
make. None of them may set a roofline of the port's kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: waterfall rows for bytes the shape fallbacks charge (provenance unknown)
UNTAGGED_DOT = "(untagged dot rhs)"
UNTAGGED_PALLAS = "(untagged pallas operand)"

#: ops whose output is a view or copy of their first operand: a tagged
#: input passes its tag on (the reference's structural primitives; the
#: composite ones, reshape, narrow or movedim, reach the mode as these)
_STRUCTURAL = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "t", "transpose", "permute",
    "expand", "select", "slice", "squeeze", "unsqueeze", "alias", "clone",
    "detach", "as_strided", "unbind", "split", "split_with_sizes",
    "_to_copy"})

#: ops charged as ``dot_general``: (lhs index, rhs index, has batch)
_PRODUCTS = {"mm": (0, 1, False), "addmm": (1, 2, False),
             "bmm": (0, 1, True), "baddbmm": (1, 2, True)}

#: data-movement ops: operand and result bytes
_MOVEMENT = frozenset({
    "gather", "scatter", "scatter_add", "scatter_reduce", "index_select",
    "index", "index_put", "_index_put_impl", "index_copy", "index_add",
    "index_fill", "embedding", "sort", "cumsum", "take_along_dim"})

#: this thread's recorder while ``analyze`` runs (the dispatch mode's
#: stack is per thread too)
_STATE = threading.local()


def _active() -> Optional["_Recorder"]:
    return getattr(_STATE, "rec", None)


def recording(*operands) -> bool:
    """Whether a kernel wrapper called on ``operands`` reports its call
    instead of launching: every tensor among them is on the meta device
    and this thread's ``analyze`` is running. While it runs, a tensor on
    any other device is refused (RuntimeError); meta tensors with nothing
    recording are left to the wrapper, which refuses them."""
    tensors = [t for t in operands if isinstance(t, torch.Tensor)]
    rec = _active()
    if rec is None:
        return False
    off = sorted({str(t.device) for t in tensors if t.device.type != "meta"})
    if off:
        raise RuntimeError(
            f"a kernel wrapper got tensors on {', '.join(off)} while "
            "op_cost.analyze runs; only its meta copies may reach a kernel")
    return True


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _nbytes(shape, dtype) -> int:
    return _numel(shape) * dtype.itemsize


def _held_nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` holds: a broadcast dim (stride 0, as
    ``torch.matmul`` expands a weight to feed ``bmm``) reads its source
    once."""
    return _numel(d for d, s in zip(t.shape, t.stride()) if s != 0) \
        * t.dtype.itemsize


class Operand:
    """A kernel operand the port does not materialise (the reference's
    padded activation, a slice of a packed array): its shape and dtype,
    and the tensor whose tag it carries."""

    def __init__(self, shape, dtype, source=None):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.source = source


class _Recorder:
    def __init__(self):
        self.acc = {"flops": 0.0, "dot_flops": 0.0, "bytes": 0.0,
                    "pallas_flops": 0.0, "pallas_bytes": 0.0,
                    "weight_bytes": 0.0}
        self.wf: Dict[str, float] = {}
        # id -> (tensor, path); the tensor is held so its id stays its own
        self._tags: Dict[int, Tuple[torch.Tensor, str]] = {}
        # id -> (convert output, convert source)
        self._src: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # inside ``one_product``: ids of the weight operands charged so far
        self.seen: Optional[set] = None

    def tag(self, t, path: str):
        self._tags[id(t)] = (t, path)

    def _own_tag(self, t) -> Optional[str]:
        hit = self._tags.get(id(t))
        return None if hit is None else hit[1]

    def source(self, t):
        """The convert source of ``t`` (``t`` itself if it is no convert)."""
        hit = self._src.get(id(t))
        return t if hit is None else hit[1]

    def tag_of(self, t) -> Optional[str]:
        if isinstance(t, Operand):
            return None if t.source is None else self.tag_of(t.source)
        p = self._own_tag(t)
        if p is None:
            p = self._own_tag(self.source(t))
        return p

    def charge(self, b: int, path: str):
        self.acc["weight_bytes"] += b
        self.wf[path] = self.wf.get(path, 0.0) + b

    # -- aten ops -----------------------------------------------------------
    def op(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        first = args[0] if args else None
        if name in _STRUCTURAL and isinstance(first, torch.Tensor):
            path = self.tag_of(first)
            if path is not None:
                for o in outs:
                    self.tag(o, path)
        if name == "_to_copy" and isinstance(first, torch.Tensor):
            for o in outs:
                self._src[id(o)] = (o, first)
            return
        if name in _PRODUCTS:
            self._product(name, args, outs[0])
            return
        self.acc["flops"] += sum(o.numel() for o in outs)
        if name in _MOVEMENT:
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            self.acc["bytes"] += (sum(_nbytes(o.shape, o.dtype) for o in outs)
                                  + sum(_nbytes(a.shape, a.dtype)
                                        for a in ins))

    def _product(self, name, args, out):
        li, ri, batched = _PRODUCTS[name]
        lhs, rhs = args[li], args[ri]
        f = 2 * out.numel() * int(lhs.shape[-1])
        self.acc["dot_flops"] += f
        self.acc["flops"] += f
        srcs = [self.source(lhs), self.source(rhs)]
        self.acc["bytes"] += (sum(_held_nbytes(s) for s in srcs)
                              + _nbytes(out.shape, out.dtype))
        charged = [False, False]
        for i, v in enumerate((lhs, rhs)):
            path = self.tag_of(v)
            if path is not None:
                charged[i] = True
                if self.seen is not None:
                    if id(v) in self.seen:
                        continue
                    self.seen.add(id(v))
                self.charge(_held_nbytes(srcs[i]), path)
        if (not charged[1] and not batched and srcs[1].ndim == 2
                and torch._C._current_graph_task_id() < 0):
            self.charge(_held_nbytes(srcs[1]), UNTAGGED_DOT)

    # -- kernels ------------------------------------------------------------
    def kernel(self, flops, operands, results):
        self.acc["dot_flops"] += flops
        self.acc["flops"] += flops
        self.acc["pallas_flops"] += flops
        b = sum(_nbytes(v.shape, v.dtype) for v in list(operands) + results)
        self.acc["bytes"] += b
        self.acc["pallas_bytes"] += b
        for v in operands:
            if _is_pallas_weight(v):
                self.charge(_nbytes(v.shape, v.dtype),
                            self.tag_of(v) or UNTAGGED_PALLAS)


def _is_pallas_weight(v) -> bool:
    """The reference's ``_is_pallas_weight``: integer operands (payloads,
    index tables), float (1, N) scales and float operands of rank != 2
    (block payloads) are stored weights; a plain rank-2 float activation
    is not."""
    if not v.dtype.is_floating_point:
        return True
    return len(v.shape) != 2 or v.shape[0] == 1


def kernel(flops: float, operands, results):
    """Report one call of a DB-PIM kernel (one ``pallas_call`` of the
    reference): ``flops`` into ``dot_flops`` and ``pallas_flops``, operand
    and result bytes, and weight bytes for every weight-like operand
    (``_is_pallas_weight``) to its tag, else ``UNTAGGED_PALLAS``.
    ``operands`` are tensors or ``Operand``s in the reference's order;
    ``results`` the outputs (tensors or ``Operand``s)."""
    _active().kernel(float(flops), list(operands), list(results))


def charge_ops(dot_flops: float = 0, flops: float = 0, nbytes: float = 0):
    """Charge what a kernel that replaces plain ops of the reference costs
    there: ``dot_flops`` (einsums, counted in ``flops`` too), the other
    ``flops``, and ``nbytes`` of product operands and results. No weight
    bytes."""
    acc = _active().acc
    acc["dot_flops"] += dot_flops
    acc["flops"] += dot_flops + flops
    acc["bytes"] += nbytes


@contextlib.contextmanager
def one_product():
    """Charge the products issued inside as the one product the reference
    computes where the port issues one per group (``models.moe._route``:
    one (Tg, D) @ (D, E) router product per group, so a chunk's groups run
    decode's product; the reference's is one (G, Tg, D) @ (D, E)): each
    weight operand's bytes are charged at its first product only. A no-op
    when nothing is recording."""
    rec = _active()
    if rec is None:
        yield
        return
    prev, rec.seen = rec.seen, set()
    try:
        yield
    finally:
        rec.seen = prev


class _Mode(TorchDispatchMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec.op(func, args, kwargs, out)
        return out


def _leaves_with_path(tree, prefix=()):
    """(path tuple, leaf) of a nested dict / list / tuple (NamedTuples by
    field name), in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (str(i),))
    else:
        yield prefix, tree


def to_meta(tree, memo: Optional[Dict[int, torch.Tensor]] = None):
    """``tree`` with every tensor leaf replaced by an empty meta tensor of
    its shape, dtype and strides; a tensor met twice maps to one copy
    (``memo``: id -> meta copy). Containers: dict, list, tuple, NamedTuple
    and dataclass instances (the serving tables)."""
    memo = {} if memo is None else memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = torch.empty_strided(
                tree.shape, tree.stride(), dtype=tree.dtype, device="meta")
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {k: to_meta(v, memo) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v, memo) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v, memo) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: to_meta(getattr(tree, f.name), memo)
                             for f in dataclasses.fields(tree) if f.init})
    return tree


def analyze(fn, *args, weight_argnums: Tuple[int, ...] = (0,),
            const_weights: Dict[str, Any] = None) -> Dict[str, float]:
    """Cost of one call ``fn(*args)``, run on meta copies of ``args`` under
    ``torch.no_grad()``: nothing is launched or allocated on a device, and
    ``args`` are left as they were.

    weight_argnums: the positional args that hold stored parameters; their
    tensor leaves seed the provenance tags by path. const_weights:
    {label: tensor or tree} of stored weights ``fn`` closes over, tagged
    "<label>/<path>" by identity; ``fn`` must close over exactly those
    tensors, on the meta device (``to_meta``; ``obs.waterfall`` builds its
    steps so).

    Returns the reference's keys: flops, dot_flops, bytes, pallas_flops,
    pallas_bytes, weight_bytes, arg_bytes and weight_bytes_by_path (rows
    that sum to weight_bytes exactly)."""
    if _active() is not None:
        raise RuntimeError("analyze does not nest")
    memo: Dict[int, torch.Tensor] = {}
    metas = [to_meta(a, memo) for a in args]
    rec = _Recorder()
    for i in weight_argnums:
        if 0 <= i < len(metas):
            for path, leaf in _leaves_with_path(metas[i]):
                if isinstance(leaf, torch.Tensor):
                    rec.tag(leaf, "/".join(path))
    for label, tree in (const_weights or {}).items():
        for path, leaf in _leaves_with_path(tree):
            if isinstance(leaf, torch.Tensor):
                rec.tag(leaf, "/".join((label,) + path))
    _STATE.rec = rec
    try:
        with torch.no_grad(), _Mode(rec):
            fn(*metas)
    finally:
        _STATE.rec = None
    acc: Dict[str, Any] = dict(rec.acc)
    acc["arg_bytes"] = float(sum(_nbytes(t.shape, t.dtype)
                                 for t in memo.values()))
    acc["weight_bytes_by_path"] = rec.wf
    return acc


def analyze_call_kinds(calls: Dict[str, tuple],
                       const_weights: Dict[str, Any] = None
                       ) -> Dict[str, Dict[str, float]]:
    """{call kind: analyze(fn, *args)} for ``calls`` {kind: (fn, args)},
    each kind analysed on its own, so every tally stays with the call that
    pays it (a parallel SSM chunk reads its projections once, an exact
    chunk C times)."""
    return {kind: analyze(fn, *args, const_weights=const_weights)
            for kind, (fn, args) in calls.items()}
