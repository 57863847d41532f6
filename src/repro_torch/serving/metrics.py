"""Serving metrics: TTFT, per-token latency, throughput, queue depth.

Port of ``repro.serving.metrics`` for what the port's engine records (the
fault, shedding, paging and snapshot counters come with those slices).
Two clocks, kept separate on purpose:

  * ENGINE TICKS / DEVICE STEPS — deterministic, trace-reproducible.
  * WALL CLOCK — tokens/sec, per-token latency and per-call latency,
    measured around the engine run for reporting only.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.histogram import LogHistogram


@dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    gen_len: int
    arrival: float
    admitted_tick: Optional[int] = None
    first_token_tick: Optional[int] = None
    done_tick: Optional[int] = None
    prefill_steps: int = 0            # device calls spent filling the cache
    #: terminal outcome: "done" or "rejected" (refused at submit); None
    #: while queued / in flight
    outcome: Optional[str] = None
    reason: Optional[str] = None      # rejected: why

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Arrival -> first generated token, in engine ticks."""
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - int(self.arrival)

    @property
    def admission_wait_ticks(self) -> Optional[int]:
        """Arrival -> admission, in engine ticks."""
        if self.admitted_tick is None:
            return None
        return self.admitted_tick - int(self.arrival)


@dataclass
class TickMetrics:
    tick: int
    queue_depth: int
    n_prefilling: int
    n_decoding: int
    device_calls: int


class MetricsRecorder:
    """Accumulates per-request and per-tick serving metrics."""

    def __init__(self):
        self.requests: Dict[int, RequestMetrics] = {}
        self.ticks: List[TickMetrics] = []
        self.decode_calls = 0
        self.prefill_calls = 0
        self.generated_tokens = 0
        self.rejected = 0                       # refused at submit
        #: device calls by the step's call_kind tag
        self.calls_by_kind: Dict[str, int] = {}
        #: per-call wall latency, log-bucketed per call_kind tag
        self.call_latency: Dict[str, LogHistogram] = {}
        self._slot_log: List[Tuple[int, int, Optional[int]]] = []
        self._n_slots: int = 0
        self._t0: Optional[float] = None
        self._wall: float = 0.0

    @property
    def device_calls(self) -> int:
        return self.decode_calls + self.prefill_calls

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._t0 = time.monotonic()

    def stop(self):
        if self._t0 is not None:
            self._wall += time.monotonic() - self._t0
            self._t0 = None

    # -- events ------------------------------------------------------------
    def on_submit(self, rid, prompt_len, gen_len, arrival):
        self.requests[rid] = RequestMetrics(
            rid=rid, prompt_len=prompt_len, gen_len=gen_len, arrival=arrival)

    def on_reject(self, rid, prompt_len, gen_len, arrival, reason: str):
        """A request refused at submit: recorded, never admitted. A
        duplicate rid keeps the original request's row."""
        self.rejected += 1
        if rid in self.requests:
            return
        r = RequestMetrics(rid=rid, prompt_len=prompt_len, gen_len=gen_len,
                           arrival=arrival)
        r.outcome, r.reason = "rejected", reason
        self.requests[rid] = r

    def on_admit(self, rid, tick):
        self.requests[rid].admitted_tick = tick

    def on_prefill_step(self, rid):
        self.requests[rid].prefill_steps += 1

    def on_first_token(self, rid, tick):
        self.requests[rid].first_token_tick = tick

    def on_token(self, rid):
        self.generated_tokens += 1

    def on_done(self, rid, tick):
        self.requests[rid].done_tick = tick
        self.requests[rid].outcome = "done"

    def on_tick(self, tick, queue_depth, n_prefilling, n_decoding,
                device_calls):
        self.ticks.append(TickMetrics(tick, queue_depth, n_prefilling,
                                      n_decoding, device_calls))

    def on_device_call(self, call: str, kind: Optional[str] = None,
                       dur_s: Optional[float] = None):
        """``call`` is the engine phase ("decode" | "prefill"), ``kind``
        the step's call_kind tag; ``dur_s`` (wall seconds around the call)
        feeds the per-kind latency histogram."""
        if call == "decode":
            self.decode_calls += 1
        elif call == "prefill":
            self.prefill_calls += 1
        tag = kind or call
        self.calls_by_kind[tag] = self.calls_by_kind.get(tag, 0) + 1
        if dur_s is not None:
            if tag not in self.call_latency:
                self.call_latency[tag] = LogHistogram()
            self.call_latency[tag].add(dur_s)

    def record_slot_log(self, intervals: List[Tuple[int, int, Optional[int]]],
                        n_slots: int):
        """Install the engine's slot audit log — [(slot, admit_tick,
        release_tick-or-None), ...] — for slot_busy_frac / occupancy."""
        self._slot_log = list(intervals)
        self._n_slots = n_slots

    # -- summaries ---------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate serving metrics. TTFT aggregates cover the requests
        that reached a first token; percentiles are nearest-rank."""
        ttfts = sorted(r.ttft_ticks for r in self.requests.values()
                       if r.first_token_tick is not None)
        admitted = [r for r in self.requests.values()
                    if r.admitted_tick is not None]

        def pct(xs, q):
            if not xs:
                return None
            return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]

        toks = self.generated_tokens
        calls = max(self.device_calls, 1)
        qd = [t.queue_depth for t in self.ticks]
        n_completed = sum(r.done_tick is not None
                          for r in self.requests.values())
        n_ticks = len(self.ticks)
        slot_busy_frac = slot_occupancy = None
        if self._n_slots and n_ticks:
            busy = [0] * self._n_slots
            for slot, admit, release in self._slot_log:
                end = n_ticks if release is None else min(release, n_ticks)
                busy[slot] += max(end - admit, 0)
            slot_occupancy = [b / n_ticks for b in busy]
            slot_busy_frac = sum(busy) / (self._n_slots * n_ticks)
        return {
            "n_requests": len(self.requests),
            "n_completed": n_completed,
            "n_rejected": self.rejected,
            "calls_by_kind": dict(self.calls_by_kind),
            "call_latency_ms": {tag: h.summary_ms()
                                for tag, h in self.call_latency.items()},
            "slot_busy_frac": slot_busy_frac,
            "slot_occupancy": slot_occupancy,
            "goodput": n_completed / max(len(self.requests), 1),
            "ttft_n": len(ttfts),
            "generated_tokens": toks,
            "engine_ticks": n_ticks,
            "device_calls": self.device_calls,
            "decode_calls": self.decode_calls,
            "prefill_calls": self.prefill_calls,
            "tokens_per_step": toks / calls,
            "steps_per_token": calls / max(toks, 1),
            "ttft_ticks_mean": (sum(ttfts) / len(ttfts)) if ttfts else None,
            "ttft_ticks_p50": pct(ttfts, 0.50),
            "ttft_ticks_p95": pct(ttfts, 0.95),
            "prefill_steps_per_request_mean": (
                sum(r.prefill_steps for r in admitted) / len(admitted)
                if admitted else None),
            "queue_depth_mean": (sum(qd) / len(qd)) if qd else 0.0,
            "queue_depth_max": max(qd) if qd else 0,
            "wall_s": self._wall,
            "tokens_per_sec": (toks / self._wall) if self._wall else None,
            "per_token_latency_ms": (1e3 * self._wall / toks
                                     if self._wall and toks else None),
        }

    def per_request(self) -> List[dict]:
        out = []
        for r in sorted(self.requests.values(), key=lambda r: r.rid):
            out.append({
                "rid": r.rid, "prompt_len": r.prompt_len,
                "gen_len": r.gen_len, "arrival": r.arrival,
                "admitted_tick": r.admitted_tick,
                "admission_wait_ticks": r.admission_wait_ticks,
                "first_token_tick": r.first_token_tick,
                "done_tick": r.done_tick,
                "ttft_ticks": r.ttft_ticks,
                "prefill_steps": r.prefill_steps,
                "outcome": r.outcome,
                "reason": r.reason,
            })
        return out
