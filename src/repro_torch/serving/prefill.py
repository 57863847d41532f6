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
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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
