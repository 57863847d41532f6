"""Serving metrics: TTFT, per-token latency, throughput, queue depth.

Port of ``repro.serving.metrics``, whole: the same events, counters,
``summary()`` keys, ``per_request()`` rows and ``state_dict()`` layout, so
a port state dict loads into the reference recorder and back. The paging
counters (``on_preempt``, ``on_alloc_failure``) wait for the paged engine.

Two clocks, kept separate on purpose:

  * ENGINE TICKS / DEVICE STEPS — deterministic, trace-reproducible.
    TTFT in ticks and steps-per-served-token are what benchmarks guard
    (they cannot flake with machine load).
  * WALL CLOCK — tokens/sec and per-token latency, measured around the
    engine run for reporting only; traces themselves carry no wall time.
"""

from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.histogram import LogHistogram


@dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    gen_len: int
    arrival: float
    deadline: Optional[float] = None  # SLO tick; None = no deadline
    admitted_tick: Optional[int] = None
    first_token_tick: Optional[int] = None
    done_tick: Optional[int] = None
    prefill_steps: int = 0            # device calls spent filling the cache
    skips: int = 0                    # times queue-jumped before admission
    faults: int = 0                   # faults charged to this request
    replays: int = 0                  # recovery-by-replay re-prefills
    preemptions: int = 0              # page-pressure evictions suffered
    #: terminal outcome: "done", "rejected" (refused at submit),
    #: "shed" (dropped after acceptance — deadline or fault budget);
    #: None while queued / in flight
    outcome: Optional[str] = None
    reason: Optional[str] = None      # rejected/shed: why

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Arrival -> first generated token, in engine ticks."""
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - int(self.arrival)

    @property
    def admission_wait_ticks(self) -> Optional[int]:
        """Arrival -> admission, in engine ticks — the queueing share of
        TTFT, which is what SLO shedding decisions act on."""
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
    # page-pool occupancy (paged engines only; None keeps contiguous
    # engines' rows and old snapshots loadable unchanged)
    pages_used: Optional[int] = None
    pages_total: Optional[int] = None


class MetricsRecorder:
    """Accumulates per-request and per-tick serving metrics."""

    def __init__(self):
        self.requests: Dict[int, RequestMetrics] = {}
        self.ticks: List[TickMetrics] = []
        self.decode_calls = 0
        self.prefill_calls = 0
        self.generated_tokens = 0
        # fault-tolerance counters (serving.faults / engine containment)
        self.faults: Dict[str, int] = {}        # fault kind -> count
        self.retries = 0                        # re-issued device calls
        #: retries by the failed call's call_kind tag — which executable
        #: kept going down, same attribution calls_by_kind gives replay
        #: traffic
        self.retries_by_kind: Dict[str, int] = {}
        self.replays = 0                        # recovery-by-replay resets
        self.rejected = 0                       # refused at submit
        self.shed = 0                           # dropped after acceptance
        self.straggler_ticks = 0                # wall-time outlier ticks
        # paging counters (paged engines; zero otherwise)
        self.preemptions = 0                    # page-pressure evictions
        self.alloc_failures = 0                 # unsatisfiable page asks
        #: device calls by the step's call_kind tag; replay prefills are
        #: tagged "<kind>+replay" so recovery traffic is attributable
        #: (launch.steps.build_step call_kind contract)
        self.calls_by_kind: Dict[str, int] = {}
        #: per-call wall latency, log-bucketed per call_kind tag —
        #: p50/p95/p99 without storing raw samples (obs.histogram)
        self.call_latency: Dict[str, LogHistogram] = {}
        #: closed slot-occupancy intervals [(slot, admit, release), ...]
        #: + slot count, installed by the engine (record_slot_log) so
        #: summary() can aggregate the audit log into utilization
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
        # accumulate (don't overwrite): a restored engine loads the dead
        # process's wall total via load_state_dict and adds its own
        # start/stop segment on top
        if self._t0 is not None:
            self._wall += time.monotonic() - self._t0
            self._t0 = None

    # -- events ------------------------------------------------------------
    def on_submit(self, rid, prompt_len, gen_len, arrival, deadline=None):
        self.requests[rid] = RequestMetrics(
            rid=rid, prompt_len=prompt_len, gen_len=gen_len,
            arrival=arrival, deadline=deadline)

    def on_admit(self, rid, tick, skips: int = 0):
        r = self.requests[rid]
        if r.admitted_tick is None:
            # a preempted request's RE-admission must not move its
            # admission-wait clock — the user-visible wait ended at the
            # first admit
            r.admitted_tick = tick
            r.skips = skips

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
                device_calls, pages_used=None, pages_total=None):
        self.ticks.append(TickMetrics(tick, queue_depth, n_prefilling,
                                      n_decoding, device_calls,
                                      pages_used, pages_total))

    def on_device_call(self, call: str, kind: Optional[str] = None,
                       replay: bool = False, restore: bool = False,
                       dur_s: Optional[float] = None):
        """``call`` is the engine phase ("decode" | "prefill");
        ``kind`` the compiled step's call_kind tag, suffixed "+replay"
        when the batch carries a recovering slot and "+restore" when it
        carries a slot re-prefilling after a warm restart (restore wins:
        restart traffic is the cost snapshot cadence trades against, so
        it must not hide inside the fault-replay bucket). ``dur_s``
        (wall seconds around the device call) feeds the per-kind
        log-bucketed latency histogram."""
        if call == "decode":
            self.decode_calls += 1
        elif call == "prefill":
            self.prefill_calls += 1
        tag = kind or call
        if restore:
            from repro_torch.launch.steps import RESTORE_TAG
            tag += RESTORE_TAG
        elif replay:
            from repro_torch.launch.steps import REPLAY_TAG
            tag += REPLAY_TAG
        self.calls_by_kind[tag] = self.calls_by_kind.get(tag, 0) + 1
        if dur_s is not None:
            if tag not in self.call_latency:
                self.call_latency[tag] = LogHistogram()
            self.call_latency[tag].add(dur_s)

    # -- fault-tolerance events --------------------------------------------
    def on_reject(self, rid, prompt_len, gen_len, arrival, reason: str,
                  deadline=None):
        """A request refused at submit: recorded, never admitted. The
        row exists so ``n_requests`` still counts every submission and
        results can report the rejection. If the rid already has a row
        (a "duplicate_rid" rejection), the ORIGINAL request's row must
        survive — only the rejection counter moves, or the duplicate
        would silently erase the live request's metrics."""
        if rid in self.requests:
            self.rejected += 1
            return
        r = RequestMetrics(rid=rid, prompt_len=prompt_len, gen_len=gen_len,
                           arrival=arrival, deadline=deadline)
        r.outcome, r.reason = "rejected", reason
        self.requests[rid] = r
        self.rejected += 1

    def on_shed(self, rid, tick, reason: str):
        """A request dropped AFTER acceptance — its deadline became
        unreachable or it exhausted the per-request fault budget."""
        r = self.requests[rid]
        r.outcome, r.reason = "shed", reason
        r.done_tick = None
        self.shed += 1

    def on_fault(self, kind: str, rid: Optional[int], tick: int):
        self.faults[kind] = self.faults.get(kind, 0) + 1
        if rid is not None and rid in self.requests:
            self.requests[rid].faults += 1

    def on_retry(self, call: str):
        """``call`` is the failed step's call_kind tag; the per-kind
        count makes "which executable kept failing" answerable (the old
        recorder dropped the argument on the floor)."""
        self.retries += 1
        self.retries_by_kind[call] = self.retries_by_kind.get(call, 0) + 1

    def on_replay(self, rid):
        self.replays += 1
        self.requests[rid].replays += 1

    # -- paging events -----------------------------------------------------
    def on_preempt(self, rid, tick):
        """A request evicted from its slot under page pressure (not a
        shed — it re-enters later with its stream intact)."""
        self.preemptions += 1
        if rid in self.requests:
            self.requests[rid].preemptions += 1

    def on_alloc_failure(self):
        """A page allocation that could not be satisfied this tick —
        the admission gate held a request back, or slot growth had to
        preempt. The counter is the page-pressure signal capacity
        planning reads (alloc failures ~ 0 means the pool is sized
        generously; climbing means preemption churn)."""
        self.alloc_failures += 1

    def on_straggler(self, tick):
        self.straggler_ticks += 1

    def record_slot_log(self, intervals: List[Tuple[int, int, Optional[int]]],
                        n_slots: int):
        """Install the engine's slot audit log — [(slot, admit_tick,
        release_tick-or-None), ...] — so summary() can aggregate it into
        ``slot_busy_frac`` / per-slot occupancy. The engine calls this
        at shutdown (the log was collected all along but never
        aggregated before); open intervals count as busy through the
        last tick."""
        self._slot_log = list(intervals)
        self._n_slots = n_slots

    # -- snapshot / restore ------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable full state — everything summary()/
        per_request() derive from. Saved inside engine snapshots
        (serving.snapshot) so a warm-restarted engine reports cumulative
        metrics, not just the post-restart segment. Wall time is saved
        as the accumulated total; the live ``_t0`` segment (if the
        recorder is mid-run) is intentionally NOT folded in — a snapshot
        taken mid-tick must not double-count when the same process later
        stops cleanly."""
        return {
            "requests": [asdict(r)
                         for r in sorted(self.requests.values(),
                                         key=lambda r: r.rid)],
            "ticks": [asdict(t) for t in self.ticks],
            "decode_calls": self.decode_calls,
            "prefill_calls": self.prefill_calls,
            "generated_tokens": self.generated_tokens,
            "faults": dict(self.faults),
            "retries": self.retries,
            "retries_by_kind": dict(self.retries_by_kind),
            "replays": self.replays,
            "rejected": self.rejected,
            "shed": self.shed,
            "straggler_ticks": self.straggler_ticks,
            "preemptions": self.preemptions,
            "alloc_failures": self.alloc_failures,
            "calls_by_kind": dict(self.calls_by_kind),
            "call_latency": {tag: h.to_dict()
                             for tag, h in self.call_latency.items()},
            "slot_log": [[s, a, r] for s, a, r in self._slot_log],
            "n_slots": self._n_slots,
            "wall": self._wall,
        }

    def load_state_dict(self, d: dict):
        """Inverse of state_dict (JSON round-trip safe: request rows are
        a list, so rids never go through string keys)."""
        self.requests = {int(row["rid"]): RequestMetrics(**row)
                         for row in d["requests"]}
        self.ticks = [TickMetrics(**row) for row in d["ticks"]]
        self.decode_calls = int(d["decode_calls"])
        self.prefill_calls = int(d["prefill_calls"])
        self.generated_tokens = int(d["generated_tokens"])
        self.faults = {str(k): int(v) for k, v in d["faults"].items()}
        self.retries = int(d["retries"])
        self.retries_by_kind = {str(k): int(v)
                                for k, v in d["retries_by_kind"].items()}
        self.replays = int(d["replays"])
        self.rejected = int(d["rejected"])
        self.shed = int(d["shed"])
        self.straggler_ticks = int(d["straggler_ticks"])
        # .get: pre-paging snapshots carry no paging counters
        self.preemptions = int(d.get("preemptions", 0))
        self.alloc_failures = int(d.get("alloc_failures", 0))
        self.calls_by_kind = {str(k): int(v)
                              for k, v in d["calls_by_kind"].items()}
        self.call_latency = {str(tag): LogHistogram.from_dict(h)
                             for tag, h in d["call_latency"].items()}
        self._slot_log = [(int(s), int(a), None if r is None else int(r))
                          for s, a, r in d["slot_log"]]
        self._n_slots = int(d["n_slots"])
        self._wall = float(d["wall"])
        self._t0 = None

    # -- summaries ---------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate serving metrics.

        TTFT aggregates are computed over requests that REACHED a first
        token only — requests still queued/prefilling at shutdown have no
        TTFT yet, and folding a placeholder in would bias the mean.
        Instead of dropping them silently they are counted explicitly:
        ``ttft_n`` requests contributed, ``n_no_first_token`` did not
        (``ttft_n + n_no_first_token == n_requests`` always). All TTFT
        fields are None when nothing reached a first token (the
        all-queued-at-shutdown edge), never a crash. Percentiles are
        nearest-rank (ceil(q*n)-1), so p95 of 20 samples is the 19th
        value, not the max. ``prefill_steps_per_request_mean`` averages
        over every ADMITTED request — half-prefilled requests did real
        device work and dropping them would understate prefill cost.
        """
        with_ft = [r for r in self.requests.values()
                   if r.first_token_tick is not None]
        ttfts = sorted(r.ttft_ticks for r in with_ft)
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
        # slot utilization from the audit log (record_slot_log): busy
        # ticks per slot / engine ticks; open intervals run to the end
        n_ticks = len(self.ticks)
        slot_busy_frac = None
        slot_occupancy = None
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
            # fault-tolerance block: what went wrong and what it cost.
            # goodput is the serving-under-faults headline — completed
            # over EVERY submission, rejected and shed included.
            "n_rejected": self.rejected,
            "n_shed": self.shed,
            "faults": dict(self.faults),
            "n_faults": sum(self.faults.values()),
            "retries": self.retries,
            "retries_by_kind": dict(self.retries_by_kind),
            "replays": self.replays,
            "straggler_ticks": self.straggler_ticks,
            # paging block: preemption churn + page-pool occupancy over
            # the run (None when the engine is not paged)
            "n_preemptions": self.preemptions,
            "page_alloc_failures": self.alloc_failures,
            "pages_used_mean": (
                sum(pu) / len(pu) if (pu := [t.pages_used
                                             for t in self.ticks
                                             if t.pages_used is not None])
                else None),
            "pages_used_max": max(pu) if pu else None,
            "pages_total": next(
                (t.pages_total for t in self.ticks
                 if t.pages_total is not None), None),
            "calls_by_kind": dict(self.calls_by_kind),
            "call_latency_ms": {tag: h.summary_ms()
                                for tag, h in self.call_latency.items()},
            # from the slot audit log; None until record_slot_log runs
            "slot_busy_frac": slot_busy_frac,
            "slot_occupancy": slot_occupancy,
            "goodput": n_completed / max(len(self.requests), 1),
            "ttft_n": len(ttfts),
            "n_no_first_token": len(self.requests) - len(ttfts),
            "generated_tokens": toks,
            "engine_ticks": len(self.ticks),
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
                "deadline": r.deadline,
                "admitted_tick": r.admitted_tick,
                "admission_wait_ticks": r.admission_wait_ticks,
                "first_token_tick": r.first_token_tick,
                "done_tick": r.done_tick,
                "ttft_ticks": r.ttft_ticks,
                "prefill_steps": r.prefill_steps,
                "skips": r.skips,
                "faults": r.faults,
                "replays": r.replays,
                "preemptions": r.preemptions,
                "outcome": r.outcome,
                "reason": r.reason,
            })
        return out
