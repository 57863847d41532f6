"""Prefill policies of the serving engine.

Port of ``repro.serving.prefill``. Two policies over the same per-slot
caches:

  * "chunked": fixed-shape (B, prefill_chunk) chunks through
    ``launch.steps.build_step("prefill_chunk")``, so each prefilling slot
    advances up to ``prefill_chunk`` prompt tokens per device call and
    time-to-first-token is ceil(P/C) calls;
  * "full": prompt tokens feed the ordinary (B, 1) decode step one at a
    time (P calls to first token), sharing the decode call with in-flight
    decodes. Sliding-window archs (a ring cache) take this one.

``build_chunk_step`` builds the chunked policy's step on a mesh: its
shardings at the engine's shapes, checked against the mesh, and the
compiled step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.steps import (build_prefill_chunk_step,
                                      check_on_device, compile_step)
from repro_torch.runtime import sharding as shr

PREFILL_MODES = ("chunked", "full")


def assemble_chunk(prompts: Dict[int, np.ndarray], cursors: Dict[int, int],
                   n_slots: int, chunk: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-shape chunk batch from ragged per-slot prompt cursors.

    prompts/cursors map slot -> prompt array / tokens already prefilled.
    Returns (tokens (n_slots, chunk) int32, n_valid (n_slots,) int32);
    slots absent from `prompts` get n_valid 0 (their cache is untouched
    by the chunk step). Tail chunks are ragged: n_valid < chunk."""
    tokens = np.zeros((n_slots, chunk), np.int32)
    n_valid = np.zeros((n_slots,), np.int32)
    for s, prompt in prompts.items():
        cur = cursors[s]
        n = min(chunk, len(prompt) - cur)
        if n <= 0:
            continue
        tokens[s, :n] = prompt[cur:cur + n]
        n_valid[s] = n
    return tokens, n_valid


def check_on_mesh(mesh, operands, specs, what):
    """Raise unless every spec of ``specs`` fits ``mesh`` (ValueError) and
    every tensor of ``operands`` lies on its one device
    (``launch.steps.check_on_device``)."""
    for name, tree, spec in zip(what, operands, specs):
        shr.check_fits(tree, spec, mesh, what=name)
        check_on_device(mesh, tree, name)


def build_chunk_step(cfg, mesh, params, cache, n_slots: int, chunk: int,
                     stacked_tables=None, paged: bool = False,
                     max_pages: int = 0, graphs: bool = True):
    """The fixed-shape chunk prefill step on ``mesh``, compiled
    (``launch.steps.compile_step``, the params and the cache held where
    they lie): one signature for (n_slots, chunk), so every request,
    whatever its prompt length, flows through it (ragged tails via
    n_valid). Its shardings are reckoned at those shapes and checked to
    fit the mesh, and every operand must lie on the mesh's device.

    paged=True takes the page-table variant: one extra trailing ``ptab``
    (n_slots, max_pages) int32 operand, per-call data, so page churn
    between calls keeps the one signature. The step carries the
    ``call_kind`` ("prefill_parallel" or "prefill_chunk_exact") and
    ``arch`` tags of ``build_step``."""
    step_fn, shard_fn = build_prefill_chunk_step(
        cfg, mesh, stacked_tables=stacked_tables)
    dev = mesh.device
    inputs = (torch.zeros((n_slots, chunk), dtype=torch.int32, device=dev),
              torch.zeros((n_slots,), dtype=torch.int32, device=dev))
    if paged:
        inputs += (torch.full((n_slots, max_pages), -1, dtype=torch.int32,
                              device=dev),)
    check_on_mesh(mesh, (params, cache) + inputs,
                  shard_fn(params, cache, *inputs),
                  ("params", "cache", "tokens", "n_valid", "ptab"))
    return compile_step(step_fn, buffer_argnums=(0, 1), graphs=graphs)
