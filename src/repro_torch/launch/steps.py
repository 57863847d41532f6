"""Fixed-shape serving steps, tagged with their call kind.

Port of the serving half of ``repro.launch.steps.build_step``. PyTorch
runs eagerly, so a step is a plain callable; its ``call_kind`` tag is what
the engine meters device calls and latencies under.
"""

from __future__ import annotations

import torch

from repro_torch.models import decode_chunk, decode_step, merge_slots
from repro_torch.models.config import ModelConfig

SERVE_CALL_KINDS = ("decode", "prefill_chunk")


def build_step(cfg: ModelConfig, call_kind: str, *, stacked_tables=None):
    """One serving step. ``call_kind``:

      * "decode" — the engine's slot decode step, ``(params, cache, token,
        active)``: every slot computes, and ``merge_slots`` discards the
        cache writes and position advances of inactive ones. Tag "decode".
      * "prefill_chunk" — chunked cache-filling prefill, ``(params, cache,
        tokens, n_valid)`` through ``models.decode_chunk``. Tag
        "prefill_chunk_exact": attention chunks are the decode math.

    stacked_tables (sparsity.sparse_linear.build_stacked_tables) route every
    projection of every layer through the joint kernel."""
    if call_kind not in SERVE_CALL_KINDS:
        raise ValueError(f"call_kind {call_kind!r} not in "
                         f"{SERVE_CALL_KINDS}")
    if call_kind == "decode":
        @torch.no_grad()
        def step_fn(params, cache, token, active):
            logits, new_cache = decode_step(params, cache, token, cfg,
                                            tables=stacked_tables)
            return logits, merge_slots(new_cache, cache, active, cfg)
        step_fn.call_kind = "decode"
    else:
        if cfg.serving_capabilities().parallel_prefill:
            raise NotImplementedError("SSM prefill chunks are not ported yet")

        @torch.no_grad()
        def step_fn(params, cache, tokens, n_valid):
            return decode_chunk(params, cache, tokens, n_valid, cfg,
                                tables=stacked_tables)
        step_fn.call_kind = "prefill_chunk_exact"
    step_fn.arch = cfg.name
    return step_fn
