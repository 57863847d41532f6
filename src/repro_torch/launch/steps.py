"""The train step, fixed-shape serving steps tagged with their call kind,
their compiled form, the full-forward prefill step, and the shardings of
each step on a mesh.

Port of ``repro.launch.steps``. ``build_step(cfg, call_kind, ...)`` gives
a serving step; its ``call_kind`` tag is what the engine meters device
calls and latencies under, and the recompile sentinel keys its budget
on. The mesh-bound builders (``build_serve_step``,
``build_slot_decode_step``, ``build_prefill_chunk_step``) take ``(cfg,
mesh, ...)`` and return ``(step_fn, shardings_fn)`` as the reference's
do: ``step_fn`` is ``build_step``'s step, and ``shardings_fn`` gives the
reference's spec tuple for a call's operands (``runtime.sharding``), the
paged variants' page table replicated. ``build_train_step`` and
``build_prefill_step`` return their steps alone; their shardings come from
``train_shardings`` and ``prefill_shardings`` beside them. Specs are
reckoned the same on the pod meshes (the dry run) and on the one-card
mesh the port runs on, where every spec names axes of size 1 and no
operand moves: a step given a mesh runs on that mesh's one device or
raises. The train step runs eagerly.

``compile_step`` compiles a serving step: on the card each input
signature is captured once as a CUDA graph and replayed from then on, so
a call costs one graph launch instead of a Python walk over ~1,200 kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.models import (decode_chunk_, decode_step, decode_step_,
                                loss_fn, prefill, reset_slots_)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWState, adamw_update,
                               cosine_with_warmup)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.sharding import P


def trainable(params):
    """``params`` with every floating leaf requiring grad (a leaf of the
    autograd graph), the others as they are."""
    return tree_map(lambda t: t.detach().requires_grad_()
                    if t.is_floating_point() else t, params)


def _batch_on(batch, device):
    """The batch's arrays (numpy or tensors) as tensors on ``device``, in
    their own dtypes."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def check_on_device(mesh, tree, what: str):
    """Raise unless the tensors of ``tree`` lie on ``mesh``'s one device
    (RuntimeError for a mesh of more than one device). A pod mesh's step
    is only reckoned, on meta tensors (the dry run): those pass."""
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if not mesh.devices and all(t.device.type == "meta" for t in leaves):
        return
    dev = mesh.device
    off = sorted({str(t.device) for t in leaves if t.device != dev})
    if off:
        raise ValueError(f"{what} on {', '.join(off)}, not on the mesh's "
                         f"device {dev}")


def build_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                     grad_compression: bool = False, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``, the reference's step on one device, eagerly: the gradients of
    ``models.loss_fn`` by autograd (on the card through the row kernels'
    backward kernels), with ``microbatches`` > 1 the batch split in that
    many equal row blocks, their gradients summed in float32 and divided
    (as is the loss); ``runtime.compression.compress_tree`` on them with
    ``grad_compression``; then ``adamw_update`` at
    ``cosine_with_warmup(opt_state.step)``. ``params`` are the trainable
    tree (``trainable``); the new params are too; the loss a detached
    float32 scalar. A leaf the loss does not reach gets a zero gradient,
    as ``jax.grad`` gives it. The gradients are taken with grad mode on
    whatever the caller's mode. With ``mesh`` the params must lie on its
    one device (``train_shardings(mesh)`` gives their specs)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch, cfg)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        it = iter(gs)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(params, opt_state: AdamWState, batch):
        if mesh is not None:
            check_on_device(mesh, params, "params")
        dev = tree_leaves(params)[0].device
        batch = _batch_on(batch, dev)
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            grad_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = grads_of(params, part)
                loss_sum = loss_sum + loss
                grad_sum = tree_map(torch.add, grad_sum, g)
            loss = loss_sum / microbatches
            grads = tree_map(lambda g: g / microbatches, grad_sum)
        else:
            loss, grads = grads_of(params, batch)
        if grad_compression:
            from repro_torch.runtime.compression import compress_tree
            grads = compress_tree(grads)
        lr = cosine_with_warmup(opt_state.step)
        new_params, new_state = adamw_update(params, grads, opt_state, lr=lr)
        return trainable(new_params), new_state, loss

    return train_step


def train_shardings(mesh):
    """``shardings(params, opt_state, batch) -> (pspec, ospec, bspec)``,
    the reference's train-step specs on ``mesh``: FSDP params only when a
    TP-sharded replica would strain the device (``_needs_fsdp``), ZeRO-1
    moments either way (``_moment_specs``), the batch over the DP axes."""
    def shardings(params, opt_state, batch):
        pspec = shr.param_specs(params, mesh, fsdp=_needs_fsdp(params, mesh))
        mv_spec = _moment_specs(params, pspec, opt_state.m, mesh)
        ospec = AdamWState(step=P(), m=mv_spec, v=mv_spec)
        bspec = shr.batch_specs(batch, mesh)
        return pspec, ospec, bspec
    return shardings


def _param_bytes(params) -> int:
    return sum(t.numel() * t.dtype.itemsize for t in tree_leaves(params)
               if isinstance(t, torch.Tensor))


def _needs_fsdp(params, mesh, budget_bytes: float = 4e9) -> bool:
    """FSDP only when a TP-sharded replica exceeds ``budget_bytes``: for
    small models the per-layer weight gathers cost more than the one DP
    gradient reduction they displace."""
    return (_param_bytes(params) / mesh.shape.get("model", 1)) > budget_bytes


def _moment_specs(params, pspecs, moments, mesh):
    """ZeRO-1 moment sharding. fp32 moments mirror the param spec extended
    over the DP axes; int8 block-quantized moments ({q, scale}) shard their
    block dim over DP."""
    dpa = shr.dp_axes(mesh)
    dpa = dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    dpn = shr.axis_size(mesh, dpa)

    def one(p, spec, m):
        if isinstance(m, dict):            # int8 {q, scale}
            blk_spec = P(dpa) if m["q"].shape[0] % dpn == 0 else P()
            return {"q": blk_spec, "scale": blk_spec}
        return shr.zero1_spec(spec, tuple(p.shape), mesh)

    return tree_map(one, params, pspecs, moments)


SERVE_CALL_KINDS = ("serve", "decode", "prefill_chunk", "reset")

#: Call-kind tag suffix for recovery traffic: a quarantined slot's replay
#: re-prefills through the one compiled prefill step, and the engine
#: meters those calls under "<call_kind>+replay"
#: (``metrics.calls_by_kind``), as the reference does.
REPLAY_TAG = "+replay"

#: The same for warm-restart traffic: a slot re-prefilling its record after
#: ``ServeEngine.restore`` is metered under "<call_kind>+restore".
RESTORE_TAG = "+restore"


def build_step(cfg: ModelConfig, call_kind: str, *, stacked_tables=None,
               int8_weights: bool = False):
    """One serving step. ``call_kind``:

      * "serve" — the plain lock-step (B, 1) decode step, ``(params, cache,
        token)`` through the functional ``models.decode_step``: every slot
        at one position, a new cache returned. Tag "decode".
        ``int8_weights=True`` takes the params of
        ``sparsity.quantize_params_for_serving`` (projections INT8 with a
        per-filter scale) and dequantizes them to bf16 inside the step
        (``dequant_params_for_serving``); the projections then run as
        plain matmuls, as the reference computes them outside any kernel.
        Not with ``stacked_tables`` (the tables carry their own payload).
        It takes no page table, so a paged cache is refused (ValueError,
        from ``models.decode_step``): the lock-step step stays
        contiguous.
      * "decode" — the engine's slot decode step, ``(params, cache, token,
        active)`` through ``models.decode_step_``: every slot computes, and
        only the active ones write their k/v rows and advance. Tag
        "decode".
      * "prefill_chunk" — chunked cache-filling prefill, ``(params, cache,
        tokens, n_valid)`` through ``models.decode_chunk_``. Tag
        "prefill_parallel" when an SSM segment takes the parallel SSD chunk
        (``cfg.serving_capabilities().parallel_prefill`` and not
        ``cfg.prefill_exact``), else "prefill_chunk_exact": attention
        chunks, and SSM chunks under ``prefill_exact``, are the decode
        math.
      * "reset" — ``(cache, slot_mask)`` through ``models.reset_slots_``:
        zero the masked slots' cache slices and positions before
        admission. Tag "reset".

    The engine's steps update the cache where it lies (the counterpart of
    the reference's donated cache). Each returns ``(logits, cache)``
    ("reset": the cache), the cache being the one passed in; bitwise what
    the functional ``decode_step`` + ``merge_slots``, ``decode_chunk`` and
    ``reset_slots`` return.

    A paged cache (pools "pk" / "pv") takes one more trailing operand in
    each engine step, the page table ``ptab`` (n_slots, max_pages) int32:
    a per-call input like the tokens, so the compiled step copies it into
    its static buffer and keeps one signature.

    stacked_tables (sparsity.sparse_linear.build_stacked_tables) route every
    projection of every layer through the joint kernel."""
    if call_kind not in SERVE_CALL_KINDS:
        raise ValueError(f"call_kind {call_kind!r} not in "
                         f"{SERVE_CALL_KINDS}")
    if int8_weights and stacked_tables is not None:
        raise ValueError("int8_weights and stacked_tables are mutually "
                         "exclusive serving formats")
    if int8_weights and call_kind != "serve":
        raise ValueError("int8_weights is a 'serve' step format")
    if call_kind == "serve":
        @torch.no_grad()
        def step_fn(params, cache, token):
            if int8_weights:
                from repro_torch.sparsity.sparse_linear import \
                    dequant_params_for_serving
                params = dequant_params_for_serving(params)
            return decode_step(params, cache, token, cfg,
                               tables=stacked_tables)
        step_fn.call_kind = "decode"
    elif call_kind == "decode":
        @torch.no_grad()
        def step_fn(params, cache, token, active, ptab=None):
            return decode_step_(params, cache, token, active, cfg,
                                tables=stacked_tables, ptab=ptab)
        step_fn.call_kind = "decode"
    elif call_kind == "prefill_chunk":
        @torch.no_grad()
        def step_fn(params, cache, tokens, n_valid, ptab=None):
            return decode_chunk_(params, cache, tokens, n_valid, cfg,
                                 tables=stacked_tables, ptab=ptab)
        step_fn.call_kind = (
            "prefill_parallel"
            if (cfg.serving_capabilities().parallel_prefill
                and not cfg.prefill_exact)
            else "prefill_chunk_exact")
    else:
        @torch.no_grad()
        def step_fn(cache, slot_mask, ptab=None):
            return reset_slots_(cache, slot_mask, cfg, ptab=ptab)
        step_fn.call_kind = "reset"
    step_fn.arch = cfg.name
    return step_fn


def _serving_param_specs(params, mesh):
    """Serving keeps weights resident (TP-sharded, replicated over DP):
    FSDP would gather the full model again every decoded token. Only
    models whose TP shard exceeds 12 GB (arctic-class) keep FSDP and pay
    the gathers."""
    tp = mesh.shape.get("model", 1)
    fsdp = (_param_bytes(params) / tp) > 12e9
    return shr.param_specs(params, mesh, fsdp=fsdp)


def _serving_shardings(cfg: ModelConfig, mesh, names):
    """``shardings(params, cache, *inputs)`` of a serving step whose
    per-call inputs are named ``names``: (param specs, cache specs, one
    batch spec per input), and ``P()`` for a trailing page table (tiny
    int32, replicated: sharding it would only add a gather before every
    pool lookup)."""
    def shardings(params, cache, *inputs):
        if len(inputs) not in (len(names), len(names) + 1):
            raise TypeError(f"shardings take {names} and an optional page "
                            f"table, got {len(inputs)} inputs")
        pspec = _serving_param_specs(params, mesh)
        cspec = shr.cache_specs(cache, cfg, mesh)
        bspec = shr.batch_specs(dict(zip(names, inputs)), mesh)
        out = (pspec, cspec) + tuple(bspec[k] for k in names)
        return out + (P(),) * (len(inputs) - len(names))
    return shardings


def build_serve_step(cfg: ModelConfig, mesh, int8_weights: bool = False,
                     stacked_tables=None):
    """``(step_fn, shardings_fn)``: ``build_step(cfg, "serve", ...)`` and
    its specs ``(params, cache, token)``."""
    return (build_step(cfg, "serve", stacked_tables=stacked_tables,
                       int8_weights=int8_weights),
            _serving_shardings(cfg, mesh, ("token",)))


def build_slot_decode_step(cfg: ModelConfig, mesh, stacked_tables=None):
    """``(step_fn, shardings_fn)``: ``build_step(cfg, "decode", ...)`` and
    its specs ``(params, cache, token, active[, ptab])``."""
    return (build_step(cfg, "decode", stacked_tables=stacked_tables),
            _serving_shardings(cfg, mesh, ("token", "active")))


def build_prefill_chunk_step(cfg: ModelConfig, mesh, stacked_tables=None):
    """``(step_fn, shardings_fn)``: ``build_step(cfg, "prefill_chunk",
    ...)`` and its specs ``(params, cache, tokens, n_valid[, ptab])``."""
    return (build_step(cfg, "prefill_chunk", stacked_tables=stacked_tables),
            _serving_shardings(cfg, mesh, ("tokens", "n_valid")))


def prefill_shardings(mesh):
    """``shardings(params, batch) -> (pspec, bspec)``, the reference's
    prefill-step specs on ``mesh``."""
    def shardings(params, batch):
        return (shr.param_specs(params, mesh,
                                fsdp=_needs_fsdp(params, mesh)),
                shr.batch_specs(batch, mesh))
    return shardings


def build_prefill_step(cfg: ModelConfig, stacked_tables=None, mesh=None):
    """``prefill_step(params, batch)``: the last-position logits (B, 1, V)
    of the full forward over ``batch["tokens"]`` (``models.prefill``),
    with ``batch.get("frames")`` encoded first (whisper), as
    ``models.inputs.make_train_batch`` makes them. Text only, as the
    reference's step: it does not pass ``batch["frontend"]`` (pixtral's
    patch embeddings) on; ``models.forward(frontend_embeds=...)`` takes
    them. Eager; tagged "prefill". stacked_tables route every projection
    of every layer through the joint kernel. With ``mesh`` the params must
    lie on its one device; ``prefill_shardings(mesh)`` gives the specs the
    reference's ``build_prefill_step`` returns beside its step."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            check_on_device(mesh, params, "params")
        return prefill(params, batch["tokens"], cfg,
                       frames=batch.get("frames"), tables=stacked_tables)
    prefill_step.call_kind = "prefill"
    prefill_step.arch = cfg.name
    return prefill_step


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict / tuple / list, in a fixed order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


class _Graph:
    """One captured signature: the graph, its static input buffers and its
    outputs."""

    def __init__(self, graph, inputs, out):
        self.graph = graph
        self.inputs = inputs          # {arg index: static buffer}
        self.out = out


class CompiledStep:
    """A serving step compiled once per input signature; see
    ``compile_step``."""

    def __init__(self, step_fn, buffer_argnums, graphs: bool):
        self.step_fn = step_fn
        self.call_kind = step_fn.call_kind
        self.arch = step_fn.arch
        self.buffer_argnums = frozenset(buffer_argnums)
        self.graphs = graphs
        self._compiled = {}           # signature -> _Graph (None: eager)
        self._stream = None

    def _cache_size(self) -> int:
        """Distinct input signatures compiled so far (the sentinel's count,
        the counterpart of the jit cache size)."""
        return len(self._compiled)

    def _signature(self, args):
        """Shape, dtype and device of every tensor argument, and the address
        of every tensor of the buffer arguments (a graph reads and writes
        them where they lie); any other argument by value."""
        sig = []
        for i, a in enumerate(args):
            held = i in self.buffer_argnums
            for path, leaf in _leaves(a):
                if isinstance(leaf, torch.Tensor):
                    sig.append((i, path, tuple(leaf.shape), leaf.dtype,
                                leaf.device,
                                leaf.data_ptr() if held else None))
                else:
                    sig.append((i, path, leaf))
        return tuple(sig)

    def __call__(self, *args):
        sig = self._signature(args)
        if sig in self._compiled:
            entry = self._compiled[sig]
        else:
            on_card = self.graphs and any(
                len(e) > 4 and e[4].type == "cuda" for e in sig)
            if not on_card:
                self._compiled[sig] = None
                return self.step_fn(*args)
            out, self._compiled[sig] = self._capture(args)
            return out
        if entry is None:
            return self.step_fn(*args)
        for i, buf in entry.inputs.items():
            buf.copy_(args[i])
        entry.graph.replay()
        return entry.out

    def _capture(self, args):
        """The first call of a signature: copy the per-call inputs into
        static buffers, run the step eagerly on them (the warm-up, and this
        call's result), then capture the same step into a graph without
        running it. Returns (the eager result, the graph); raises if the
        capture fails."""
        inputs = {}
        static = list(args)
        for i, a in enumerate(args):
            if i not in self.buffer_argnums:
                if not isinstance(a, torch.Tensor):
                    raise TypeError(f"{self.call_kind}: argument {i} is "
                                    f"copied into a static buffer and must "
                                    f"be a tensor, got {type(a).__name__}")
                inputs[i] = static[i] = a.clone()
        device = next(leaf.device for a in args for _, leaf in _leaves(a)
                      if isinstance(leaf, torch.Tensor)
                      and leaf.device.type == "cuda")
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.step_fn(*static)
        main.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                static_out = self.step_fn(*static)
        except Exception as exc:
            raise RuntimeError(f"capturing the {self.call_kind} step of "
                               f"{self.arch} as a CUDA graph failed: "
                               f"{exc}") from exc
        return out, _Graph(graph, inputs, static_out)


def compile_step(step_fn, *, buffer_argnums=(), graphs: bool = True):
    """Compile a ``build_step`` step: the counterpart of
    ``jax.jit(step_fn, donate_argnums=...)``.

    ``buffer_argnums`` name the arguments the step reads, and writes, where
    they lie: the params and the donated cache, updated in place by the
    steps. Every other argument (tokens, ``active``, ``n_valid``, the reset
    mask) is a tensor that each call copies into a static buffer the
    compiled step owns.

    On a CUDA tensor the first call of a signature runs eagerly on a side
    stream (the warm-up) and then captures one ``torch.cuda.CUDAGraph``;
    each later call copies its inputs into the static buffers and replays
    the graph, and returns the captured outputs, valid until the next
    replay. A capture that fails raises; nothing falls back to eager. The
    kernel wrappers count their launches on the host and not while a
    stream is being captured, so a replay adds nothing to their
    ``LAUNCHES``: the launches inside replays are read from the device's
    own records (torch.profiler), by each wrapper's kernel ``SYMBOLS``.

    Addresses. The kernels' TMA tensor maps (``csrc/gather_matmul.cuh``,
    ``csrc/tc_tile.cuh``) and every pointer argument are baked into the
    graph's kernel nodes at capture. Every tensor a captured kernel reads
    keeps its address across replays: the params and the cache are the
    buffer arguments, whose addresses are part of the signature (another
    cache is another signature); the stacked tables live in the step's
    closure; the per-call inputs are the static buffers; and every
    intermediate comes from the graph's private memory pool, which the
    graph keeps for its lifetime. An enc-dec cache's "enc_out" is such a
    cache leaf, read and never written: another encoder output is another
    signature.

    On the CPU, or with ``graphs=False``, the step runs eagerly on every
    call and still records its signature, so the recompile sentinel counts
    there too (``_cache_size``)."""
    return CompiledStep(step_fn, buffer_argnums, graphs)
