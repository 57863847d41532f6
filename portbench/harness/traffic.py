"""The seeded traffic generator: one general reader of the mixes in
``traffic/<mix>.json``.

Lengths and gaps are drawn stratified: each block of ``block`` requests
takes the distribution's ``block`` quantiles (j + 0.5) / block, in an
order the seed permutes, so every seed sends the same sizes and
arrivals, block for block, in another order, and runs of different seeds
do the same work. A mix that states ``order_seed`` takes its order from
that number and not from the run's seed: every run then offers the same
sizes at the same times, and the seed draws only the prompts' tokens
(and the weights). That is for mixes in which the order itself changes
the work: a closed loop whose long prefills fall in step or apart, an
open loop whose long prompts bunch or spread. An open loop's ``"block":
"window"`` is the window's expected arrivals, rate x seconds: every
run's window then holds one whole block. Prompt tokens are uniform over [1, vocab) from the seed
and the request's index. Times are wall-clock seconds from the window's
opening.

Length distributions (inclusive bounds):
  * ``uniform``: lo + floor(q * (hi - lo + 1));
  * ``lognormal``: round(lo * exp(sigma * Phi^-1(q))) clipped to [lo, hi]
    (the port's ``serving/workload.py`` "lognormal": lo x LogNormal(0,
    sigma), sigma 0.8 there).

Loops:
  * ``closed``: ``clients`` clients, each with one request in flight; a
    client's next request is due when its last one completes. Client c's
    j-th request is request j * clients + c of the stream. A client's
    first request generates a stratified share u in (0, 1) of its drawn
    length (at least 1), so completions spread through the window from
    its start;
  * ``open``: Poisson arrivals at ``rate_per_s``, the gaps stratified
    quantiles of the exponential.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List, Optional

import numpy as np

SEED_MASK = (1 << 63) - 1


@dataclass
class Req:
    """One request of the stream and what the window saw of it (host
    clock, seconds)."""
    index: int
    prompt: np.ndarray
    gen_len: int
    client: int = -1
    due: float = 0.0
    submit: Optional[float] = None
    first: Optional[float] = None
    done: Optional[float] = None
    rejected: bool = False
    n_out: int = 0
    #: the engine slot that served it
    slot: Optional[int] = None
    #: (stamp, tokens that arrived with it)
    stamps: List[tuple] = field(default_factory=list)


def _quantile(dist: dict, q: float) -> int:
    lo, hi = int(dist["lo"]), int(dist["hi"])
    kind = dist["dist"]
    if kind == "uniform":
        return lo + min(int(q * (hi - lo + 1)), hi - lo)
    if kind == "lognormal":
        x = lo * math.exp(dist["sigma"] * NormalDist().inv_cdf(q))
        return int(min(max(round(x), lo), hi))
    raise ValueError(f"unknown length distribution {kind!r}")


class Stream:
    """The mix's request stream for one seed (lazy, unbounded)."""

    def __init__(self, mix: dict, seed: int, vocab: int,
                 seconds: float = None):
        self.mix = mix
        self.seed = int(seed) & SEED_MASK
        self.order = int(mix.get("order_seed", seed)) & SEED_MASK
        self.vocab = int(vocab)
        block = mix.get("block", 64)
        if block == "window":
            block = max(16, round(mix["rate_per_s"] * seconds))
        self.block = int(block)
        self._cache = {}

    def _perm(self, what: str, b: int) -> np.ndarray:
        key = (what, b)
        if key not in self._cache:
            tag = {"prompt": 1, "gen": 2, "gap": 3}[what]
            rng = np.random.default_rng([self.order, tag, b])
            self._cache[key] = rng.permutation(self.block)
        return self._cache[key]

    def _q(self, what: str, i: int) -> float:
        b, j = divmod(i, self.block)
        return (self._perm(what, b)[j] + 0.5) / self.block

    def _stagger(self, client: int) -> float:
        if "stagger" not in self._cache:
            rng = np.random.default_rng([self.order, 4])
            self._cache["stagger"] = rng.permutation(self.mix["clients"])
        return (self._cache["stagger"][client] + 0.5) / self.mix["clients"]

    def prompt_len(self, i: int) -> int:
        return _quantile(self.mix["prompt_len"], self._q("prompt", i))

    def gen_len(self, i: int) -> int:
        return _quantile(self.mix["gen_len"], self._q("gen", i))

    def gap(self, i: int) -> float:
        return -math.log(1.0 - self._q("gap", i)) / self.mix["rate_per_s"]

    def request(self, i: int, client: int = -1) -> Req:
        rng = np.random.default_rng([self.seed, 0, i])
        prompt = rng.integers(1, self.vocab, size=self.prompt_len(i),
                              dtype=np.int64).astype(np.int32)
        gen = self.gen_len(i)
        if 0 <= client and i < self.mix["clients"]:
            gen = max(1, int(self._stagger(client) * gen))
        return Req(index=i, prompt=prompt, gen_len=gen, client=client)

    def closed(self, client: int, j: int) -> Req:
        return self.request(j * self.mix["clients"] + client, client)

    def arrivals(self, horizon: float) -> List[float]:
        """Open loop: due times in [0, horizon]."""
        out, t, i = [], 0.0, 0
        while True:
            t += self.gap(i)
            if t > horizon:
                return out
            out.append(t)
            i += 1

