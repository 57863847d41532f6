"""Two-clock structured tracing for the serving engine.

Port of ``repro.obs.trace``: the same records, the same JSONL format
(version 1) and the same ``validate``, so a trace of the port's engine
loads, validates and renders under either package.

Every record carries BOTH clocks the serving stack reasons in:

  * ENGINE TICKS — the deterministic scheduler clock. Tick numbers are
    trace-reproducible (same workload seed -> same tick schedule), so
    regressions expressed in ticks ("replay prefills doubled TTFT") are
    guardable in CI.
  * WALL TIME — microseconds since the tracer was created
    (``ts_us``/``dur_us``), for latency attribution and the Chrome-trace
    timeline. Wall times are reporting-only; no guard compares them.

Record taxonomy (one JSON object per line in the JSONL dump):

  ==========  =========================================================
  type        fields
  ==========  =========================================================
  meta        version, arch, plus engine config (first record)
  span        name ("tick" | "call"), tick, ts_us, dur_us, attrs
  event       name (admit | prefill | first_token | quarantine |
              replay | shed | reject | release | fault | retry |
              preempt | crash | snapshot | restore), tick, ts_us, attrs
  interval    slot, rid, admit_tick, release_tick — one closed
              SlotInterval from the engine's slot audit log
  waterfall   kind, total, rows {param path -> weight bytes} — the
              per-call-kind traffic attribution (obs.waterfall), one
              record per call kind, embedded by the serve CLI before it
              dumps a --trace-out trace
  ==========  =========================================================

The engine's span attrs. A "tick" span: queue_depth, n_prefilling,
n_decoding, device_calls (pages_used, pages_total when paged) and the
tick's host time by phase in µs, outside every call span: admit_us
(deadline shedding and admission), assemble_us (``assemble_chunk``) and
sample_us (argmax, finite checks, token and slot bookkeeping after a
call's logits reach the host). A "call" span: phase ("prefill" |
"decode" | "reset"), kind, arch, participants, ok, and enqueued_us, the
µs from the span's start to the return of the step call (inputs copied,
the step launched); the host waits on the device over the rest of a
prefill or decode span, which closes once the logits are on the host,
and a reset span closes at its enqueue point. On the card each call span
also gets device_us, the CUDA-event time on the stream from before its
first input copy to after its step, added by ``annotate`` once the
events have completed. Prefill spans add occupancy, replay, restore,
rows (slots x chunk) and rows_valid (the prompt tokens the chunk held);
decode spans occupancy; reset spans cause ("admit" | "quarantine").

Span records are appended at BEGIN time (their ``dur_us`` is filled in
at end), so the record list is start-ordered and ``validate`` can check
wall-clock monotonicity by simple iteration. ``begin``/``end`` enforce
LIFO nesting: a "call" span always closes before its enclosing "tick"
span, which is what makes the Chrome conversion a pure reformat.

While a torch profiler records (checked at every ``begin``), each span
also opens a profiler range, closed at its ``end``: "engine.tick", or
"engine.call.<phase>" for a call span, so a profiler export holds the
engine's spans and the device's kernels on the profiler's one clock. With
no profiler recording no range is opened. The range is a function-scope
one (``torch._C._profiler._RecordFunctionFast``), a host record alone:
``torch.profiler.record_function``'s user scope is mirrored onto the
device timeline as a "gpu_user_annotation" record over the range's
kernels, which a reader of the device's records would count as device
work (busy time, idle gaps).

The tracer is PASSIVE: it never issues device calls and never touches
engine decisions, so tracing on vs off is bitwise-output- and
device-call-count-identical: tests/test_torch_trace.py holds the port
to it on the CPU, and chip_smoke.py's phase 4g in device kernel launches
on the card.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import torch

TRACE_VERSION = 1

#: span names the engine emits; anything else fails validation
SPAN_NAMES = ("tick", "call")
#: instant-event names the engine emits; crash/snapshot/restore are the
#: durability lifecycle (serving.journal / serving.snapshot) — one
#: tracer may span a kill + warm restart, and stays valid because the
#: restored engine resumes at a strictly later tick
EVENT_NAMES = ("admit", "prefill", "first_token", "quarantine", "replay",
               "shed", "reject", "release", "fault", "retry", "preempt",
               "crash", "snapshot", "restore")


class TraceError(RuntimeError):
    """A structural invariant of the trace was violated (bad nesting,
    non-monotone clocks, an unclosed span, overlapping slot intervals)."""


class Tracer:
    """Collects span/event/interval records; ``dump`` writes JSONL."""

    def __init__(self, arch: Optional[str] = None, meta: Optional[dict] = None,
                 path: Optional[str] = None):
        self._wall0 = time.perf_counter()
        #: where this trace is meant to be dumped (advisory). The engine
        #: uses it for post-mortems: EngineStuckError dumps here and
        #: attaches the path, so a hung run is diagnosable offline.
        self.path = path
        self.records: List[dict] = [{
            "type": "meta", "version": TRACE_VERSION, "arch": arch,
            **(meta or {})}]
        self._open: List[dict] = []
        #: the profiler range of each open span (None: no profiler)
        self._ranges: list = []
        self._dumped = False

    # -- clocks ------------------------------------------------------------
    def now_us(self) -> float:
        """µs since the tracer was created: the clock of ``ts_us``."""
        return (time.perf_counter() - self._wall0) * 1e6

    # -- spans -------------------------------------------------------------
    def begin(self, name: str, tick: int, **attrs) -> dict:
        """Open a span; returns the handle ``end`` takes. The record is
        appended NOW (start-ordered stream); dur_us lands at ``end``."""
        span = {"type": "span", "name": name, "tick": int(tick),
                "ts_us": self.now_us(), "dur_us": None, "attrs": attrs}
        self.records.append(span)
        self._open.append(span)
        rng = None
        if torch.autograd._profiler_enabled():
            label = f"engine.{name}"
            if "phase" in attrs:
                label += f".{attrs['phase']}"
            rng = torch._C._profiler._RecordFunctionFast(label)
            rng.__enter__()
        self._ranges.append(rng)
        return span

    def end(self, span: dict, **attrs):
        """Close the MOST RECENTLY opened span (LIFO — crossing spans are
        a bug in the instrumentation, not a recordable state)."""
        if not self._open or self._open[-1] is not span:
            raise TraceError(
                f"span {span.get('name')!r} closed out of order — spans "
                f"must nest LIFO (open: "
                f"{[s['name'] for s in self._open]})")
        self._open.pop()
        rng = self._ranges.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        span["dur_us"] = self.now_us() - span["ts_us"]
        if attrs:
            span["attrs"].update(attrs)

    def annotate(self, span: dict, **attrs):
        """Add attrs to a span already closed (a reading that completes
        later, as a call's device time does); allowed until ``dump``."""
        if span["dur_us"] is None:
            raise TraceError(f"annotate of the open span {span['name']!r}: "
                             f"give its attrs to end")
        if self._dumped:
            raise TraceError("annotate after dump: the dumped trace would "
                             "lack it")
        span["attrs"].update(attrs)

    # -- instants / intervals ---------------------------------------------
    def event(self, name: str, tick: int, **attrs):
        self.records.append({"type": "event", "name": name,
                             "tick": int(tick), "ts_us": self.now_us(),
                             "attrs": attrs})

    def interval(self, slot: int, rid: int, admit_tick: int,
                 release_tick: Optional[int]):
        """One closed slot-occupancy interval [admit_tick, release_tick)
        from the engine's audit log."""
        self.records.append({"type": "interval", "slot": int(slot),
                             "rid": int(rid),
                             "admit_tick": int(admit_tick),
                             "release_tick": (None if release_tick is None
                                              else int(release_tick))})

    def waterfall(self, kind: str, rows: Dict[str, float], total: float):
        """Per-call-kind weight-traffic attribution (obs.waterfall): rows
        map parameter paths to modeled weight bytes per call."""
        self.records.append({"type": "waterfall", "kind": kind,
                             "total": float(total),
                             "rows": {k: float(v)
                                      for k, v in rows.items()}})

    # -- export ------------------------------------------------------------
    def dump(self, path: str):
        if self._open:
            raise TraceError(f"dump with open spans: "
                             f"{[s['name'] for s in self._open]}")
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")
        self._dumped = True


def load(path: str) -> List[dict]:
    """Read a JSONL trace back into the record list ``dump`` wrote."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def validate(records: List[dict]) -> Dict[str, int]:
    """Structural invariants every engine trace must satisfy:

      * first record is a meta record with a known version;
      * span/event wall clocks are monotone non-decreasing in record
        order (spans are start-ordered by construction);
      * tick numbers are monotone non-decreasing;
      * every span was closed (dur_us set, >= 0) and has a known name;
      * every "call" span lies WITHIN its tick's "tick" span on the wall
        clock, and "tick" spans never overlap each other;
      * slot intervals on one slot never overlap, release > admit.

    Returns counting stats ({"spans": n, "events": n, "intervals": n,
    "waterfalls": n}); raises TraceError on any violation.
    """
    if not records or records[0].get("type") != "meta":
        raise TraceError("trace must start with a meta record")
    if records[0].get("version") != TRACE_VERSION:
        raise TraceError(f"unknown trace version "
                         f"{records[0].get('version')!r}")
    stats = {"spans": 0, "events": 0, "intervals": 0, "waterfalls": 0}
    last_ts = -1.0
    last_tick = -1
    tick_spans: Dict[int, dict] = {}
    for i, r in enumerate(records[1:], start=1):
        t = r.get("type")
        if t == "span":
            stats["spans"] += 1
            if r.get("name") not in SPAN_NAMES:
                raise TraceError(f"record {i}: unknown span name "
                                 f"{r.get('name')!r}")
            if r.get("dur_us") is None or r["dur_us"] < 0:
                raise TraceError(f"record {i}: span {r['name']!r} "
                                 f"never closed (dur_us={r.get('dur_us')})")
            if r["name"] == "tick":
                if r["tick"] in tick_spans:
                    raise TraceError(f"record {i}: duplicate tick span "
                                     f"for tick {r['tick']}")
                prev = tick_spans.get(r["tick"] - 1)
                if prev is not None and \
                        r["ts_us"] < prev["ts_us"] + prev["dur_us"] - 1e-6:
                    raise TraceError(
                        f"record {i}: tick {r['tick']} span starts inside "
                        f"tick {r['tick'] - 1}")
                tick_spans[r["tick"]] = r
        elif t == "event":
            stats["events"] += 1
            if r.get("name") not in EVENT_NAMES:
                raise TraceError(f"record {i}: unknown event name "
                                 f"{r.get('name')!r}")
        elif t == "interval":
            stats["intervals"] += 1
            continue                      # no wall clock on intervals
        elif t == "waterfall":
            stats["waterfalls"] += 1
            continue
        elif t == "meta":
            raise TraceError(f"record {i}: meta record not first")
        else:
            raise TraceError(f"record {i}: unknown record type {t!r}")
        if r["ts_us"] < last_ts - 1e-6:
            raise TraceError(f"record {i}: wall clock went backwards "
                             f"({r['ts_us']:.1f} < {last_ts:.1f} us)")
        last_ts = max(last_ts, r["ts_us"])
        if r["tick"] < last_tick:
            raise TraceError(f"record {i}: tick went backwards "
                             f"({r['tick']} < {last_tick})")
        last_tick = r["tick"]
    # call-in-tick containment (wall clock)
    for r in records[1:]:
        if r.get("type") == "span" and r["name"] == "call":
            parent = tick_spans.get(r["tick"])
            if parent is None:
                raise TraceError(f"call span at tick {r['tick']} has no "
                                 f"tick span")
            if r["ts_us"] < parent["ts_us"] - 1e-6 or \
                    r["ts_us"] + r["dur_us"] > \
                    parent["ts_us"] + parent["dur_us"] + 1e-6:
                raise TraceError(
                    f"call span at tick {r['tick']} escapes its tick span "
                    f"on the wall clock")
    # per-slot interval exclusivity
    by_slot: Dict[int, List[dict]] = {}
    for r in records[1:]:
        if r.get("type") == "interval":
            by_slot.setdefault(r["slot"], []).append(r)
    for slot, ivs in by_slot.items():
        ivs.sort(key=lambda r: r["admit_tick"])
        prev_end = -1
        for iv in ivs:
            end = iv["release_tick"]
            if end is not None and end <= iv["admit_tick"]:
                raise TraceError(f"slot {slot}: empty/negative interval "
                                 f"[{iv['admit_tick']}, {end})")
            if iv["admit_tick"] < prev_end:
                raise TraceError(f"slot {slot}: overlapping intervals at "
                                 f"tick {iv['admit_tick']}")
            prev_end = end if end is not None else 10 ** 12
    return stats
