"""Per-call-kind weight-traffic waterfall for the serving engine.

Port of ``repro.obs.waterfall`` (its functions less the mesh). One scalar
``weight_bytes`` per call kind says whether a run's traffic moved; the
waterfall says where: every byte is attributed to the parameter path that
moved it — dense projections by their path ("blocks/attn/wq",
"blocks/moe/router", "embed/out"), packed stacked tables by family and
part ("tables/wq/w_blocks", "tables/wq/idx", ...), and shape-fallback
charges in explicit "(untagged ...)" rows. The rows sum to each kind's
``weight_bytes`` exactly (``runtime.op_cost`` charges both at the same
site with integer byte values).

Everything here runs on meta copies of the params, the cache and the
tables (``op_cost.to_meta``), through step functions built for the
purpose: nothing is launched or allocated on the card, and an engine's
compiled steps, CUDA graphs and recompile sentinel are never touched.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.launch.steps import build_step
from repro_torch.runtime.op_cost import analyze_call_kinds, to_meta


def table_const_weights(tables) -> Optional[Dict[str, object]]:
    """{label: tensor} for a SegmentedKernelTables' packed arrays, keyed
    "tables/<family>/<part>": the const_weights mapping
    ``runtime.op_cost.analyze`` tags closed-over kernel operands with.
    None when serving dense (no tables)."""
    if tables is None:
        return None
    return {f"tables/{fam}/{part}": arr
            for fam, parts in tables.arrays.items()
            for part, arr in parts.items()}


def _meta_cache(cache, n_slots: int):
    """A meta copy of ``cache`` with every "pos" leaf a (n_slots,) vector,
    the per-slot positions the engine's in-place steps take."""
    def visit(key, node):
        if isinstance(node, dict):
            return {k: visit(k, v) for k, v in node.items()}
        if key == "pos":
            return torch.empty((n_slots,), dtype=torch.int32, device="meta")
        return to_meta(node)
    return visit(None, cache)


def serving_cost_by_kind(cfg, params, cache, *, n_slots: int,
                         prefill_chunk: int, tables=None,
                         include_exact_fallback: bool = False,
                         paged: bool = False, max_pages: int = 0
                         ) -> Dict[str, Dict]:
    """Full ``op_cost`` accounting (weight_bytes, weight_bytes_by_path,
    flops, bytes) of one call of every serving call kind ``cfg`` supports,
    keyed by the step builders' call_kind tags: "decode", and with chunked
    prefill its chunk kind.

    include_exact_fallback: for parallel-SSD archs, also the exact-chunk
    step the parallel form is compared with. paged / max_pages: the steps
    take the page table (``cache`` must then be a paged cache)."""
    meta = dict(device="meta")
    params = to_meta(params)
    cache = _meta_cache(cache, n_slots)
    tables = to_meta(tables)
    extra = ()
    if paged:
        extra = (torch.empty((n_slots, max_pages), dtype=torch.int32,
                             **meta),)
    decode_fn = build_step(cfg, "decode", stacked_tables=tables)
    tok1 = torch.empty((n_slots, 1), dtype=torch.int32, **meta)
    act = torch.empty((n_slots,), dtype=torch.bool, **meta)
    calls = {decode_fn.call_kind:
             (decode_fn, (params, cache, tok1, act) + extra)}
    caps = cfg.serving_capabilities()
    if caps.chunked_prefill:
        tokc = torch.empty((n_slots, prefill_chunk), dtype=torch.int32,
                           **meta)
        nv = torch.empty((n_slots,), dtype=torch.int32, **meta)
        chunk_fn = build_step(cfg, "prefill_chunk", stacked_tables=tables)
        calls[chunk_fn.call_kind] = (chunk_fn,
                                     (params, cache, tokc, nv) + extra)
        if include_exact_fallback and caps.parallel_prefill \
                and not cfg.prefill_exact:
            exact_fn = build_step(cfg.scaled(prefill_exact=True),
                                  "prefill_chunk", stacked_tables=tables)
            calls[exact_fn.call_kind] = (exact_fn,
                                         (params, cache, tokc, nv) + extra)
    return analyze_call_kinds(calls,
                              const_weights=table_const_weights(tables))


def engine_waterfall(engine) -> Dict[str, Dict[str, object]]:
    """{call_kind: {"total": weight_bytes, "rows": {path: bytes}}} for a
    constructed ServeEngine: the traffic attribution a --trace-out run
    embeds in its trace (``Tracer.waterfall``) for the report CLI."""
    costs = serving_cost_by_kind(
        engine.cfg, engine.params, engine.cache,
        n_slots=engine.n_slots, prefill_chunk=engine.prefill_chunk,
        tables=engine.stacked_tables, paged=engine.paged,
        max_pages=getattr(engine, "max_pages_per_slot", 0))
    return {kind: {"total": float(acc["weight_bytes"]),
                   "rows": dict(acc["weight_bytes_by_path"])}
            for kind, acc in costs.items()}
