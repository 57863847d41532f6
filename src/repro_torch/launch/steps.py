"""Fixed-shape serving steps, tagged with their call kind, their compiled
form, and the full-forward prefill step.

Port of the serving half of ``repro.launch.steps`` (``build_step``,
``build_prefill_step``) and of the engine's ``jax.jit(...,
donate_argnums=...)``. ``build_step`` returns a
plain callable; its ``call_kind`` tag is what the engine meters device
calls and latencies under, and the recompile sentinel keys its budget on.
``compile_step`` compiles one: on the card each input signature is
captured once as a CUDA graph and replayed from then on, so a call costs
one graph launch instead of a Python walk over ~1,200 kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.models import (decode_chunk_, decode_step_, prefill,
                                reset_slots_)
from repro_torch.models.config import ModelConfig

SERVE_CALL_KINDS = ("decode", "prefill_chunk", "reset")


def build_step(cfg: ModelConfig, call_kind: str, *, stacked_tables=None):
    """One serving step, updating the cache where it lies (the counterpart
    of the reference's donated cache). ``call_kind``:

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

    Each returns ``(logits, cache)`` ("reset": the cache), the cache being
    the one passed in; bitwise what the functional ``decode_step`` +
    ``merge_slots``, ``decode_chunk`` and ``reset_slots`` return.

    stacked_tables (sparsity.sparse_linear.build_stacked_tables) route every
    projection of every layer through the joint kernel."""
    if call_kind not in SERVE_CALL_KINDS:
        raise ValueError(f"call_kind {call_kind!r} not in "
                         f"{SERVE_CALL_KINDS}")
    if call_kind == "decode":
        @torch.no_grad()
        def step_fn(params, cache, token, active):
            return decode_step_(params, cache, token, active, cfg,
                                tables=stacked_tables)
        step_fn.call_kind = "decode"
    elif call_kind == "prefill_chunk":
        @torch.no_grad()
        def step_fn(params, cache, tokens, n_valid):
            return decode_chunk_(params, cache, tokens, n_valid, cfg,
                                 tables=stacked_tables)
        step_fn.call_kind = (
            "prefill_parallel"
            if (cfg.serving_capabilities().parallel_prefill
                and not cfg.prefill_exact)
            else "prefill_chunk_exact")
    else:
        @torch.no_grad()
        def step_fn(cache, slot_mask):
            return reset_slots_(cache, slot_mask, cfg)
        step_fn.call_kind = "reset"
    step_fn.arch = cfg.name
    return step_fn


def build_prefill_step(cfg: ModelConfig, stacked_tables=None):
    """``prefill_step(params, batch)``: the last-position logits (B, 1, V)
    of the full forward over ``batch["tokens"]`` (``models.prefill``),
    with ``batch.get("frames")`` encoded first (whisper), as
    ``models.inputs.make_train_batch`` makes them. Text only, as the
    reference's step: it does not pass ``batch["frontend"]`` (pixtral's
    patch embeddings) on; ``models.forward(frontend_embeds=...)`` takes
    them. Eager; tagged "prefill". stacked_tables route every projection
    of every layer through the joint kernel. (The reference's
    ``build_prefill_step`` also returns its shardings; one card has
    none.)"""
    @torch.no_grad()
    def prefill_step(params, batch):
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
