"""Trace-driven load generation for the serving engine.

Traces are fully deterministic and carry NO wall-clock: arrival times are
measured in abstract ENGINE TICKS (one tick = one scheduler iteration),
inter-arrival gaps are Poisson (exponential with a fixed-seed generator),
and prompt/generation lengths come from configurable distributions. The
same spec + seed always yields the same trace, so engine runs are
reproducible and two prefill policies can be compared on identical load
— the methodology real-PIM workload studies (Gómez-Luna et al.; CIMinus)
use to keep architecture comparisons honest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One serving request. ``arrival`` is in engine ticks (no wall
    clock); the engine admits the request at the first tick >= arrival
    with a free slot. ``deadline`` (also in ticks) is the SLO: the
    request must be DONE by that tick or the engine sheds it — queued
    requests whose optimistic completion estimate already overshoots are
    dropped without ever occupying a slot, in-flight ones are preempted
    the tick the deadline becomes unreachable. None = no SLO."""
    rid: int
    prompt: Tuple[int, ...]            # prompt token ids, len >= 1
    gen_len: int                       # tokens to generate after prefill
    arrival: float = 0.0
    deadline: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass(frozen=True)
class WorkloadSpec:
    """Knobs of the load generator. ``prompt_len`` / ``gen_len`` are
    inclusive (lo, hi) ranges; ``dist`` picks how prompt lengths spread:

      * "uniform":   plen ~ U[lo, hi] — mixed-length traffic;
      * "bimodal":   short (lo) and long (hi) prompts, 50/50 — the
                     chat-vs-document mix that stresses chunked prefill;
      * "fixed":     every prompt is exactly hi.
      * "lognormal": lo * LogNormal(0, 0.8) clipped to [lo, hi] — the
                     right-skewed long-tail real request logs show (most
                     prompts short, a heavy tail of long ones), the shape
                     that makes static worst-case cache slots wasteful
                     and paged pools win;
      * "zipf":      lo - 1 + Zipf(2.0) clipped to [lo, hi] — an even
                     heavier power-law tail.

    ``gen_dist`` spreads GENERATION lengths over ``gen_len`` with the
    same choices (default "uniform", matching older traces bit-for-bit).

    ``arrival_rate`` is requests per engine tick (Poisson); 0 puts every
    arrival at tick 0 (closed-loop batch). ``deadline_slack`` (ticks)
    gives every request the SLO ``deadline = arrival + deadline_slack``;
    None (default) disables deadlines entirely."""
    n_requests: int = 8
    arrival_rate: float = 0.5
    prompt_len: Tuple[int, int] = (4, 24)
    gen_len: Tuple[int, int] = (4, 12)
    dist: str = "uniform"
    gen_dist: str = "uniform"
    seed: int = 0
    deadline_slack: Optional[float] = None


def _sample_len(rng, lo: int, hi: int, dist: str) -> int:
    if dist == "fixed":
        return hi
    if dist == "bimodal":
        return lo if rng.random() < 0.5 else hi
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "lognormal":
        return int(np.clip(round(lo * rng.lognormal(0.0, 0.8)), lo, hi))
    if dist == "zipf":
        return int(np.clip(lo - 1 + rng.zipf(2.0), lo, hi))
    raise ValueError(f"unknown dist {dist!r}")


def make_trace(spec: WorkloadSpec, vocab_size: int) -> List[Request]:
    """Deterministic request trace for `spec` (same spec -> same trace)."""
    rng = np.random.default_rng(spec.seed)
    t = 0.0
    out: List[Request] = []
    for rid in range(spec.n_requests):
        if spec.arrival_rate > 0:
            t += float(rng.exponential(1.0 / spec.arrival_rate))
        plen = _sample_len(rng, *spec.prompt_len, spec.dist)
        glen = _sample_len(rng, *spec.gen_len, spec.gen_dist)
        prompt = tuple(int(x) for x in
                       rng.integers(1, vocab_size, size=max(plen, 1)))
        out.append(Request(rid=rid, prompt=prompt, gen_len=max(glen, 1),
                           arrival=t,
                           deadline=(t + spec.deadline_slack
                                     if spec.deadline_slack is not None
                                     else None)))
    return out
