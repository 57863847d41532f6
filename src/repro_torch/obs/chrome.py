"""Chrome-trace (Perfetto-loadable) conversion of engine traces.

Port of ``repro.obs.chrome``, record for record.

``to_chrome_trace`` reformats the obs.trace record stream into the
Trace Event Format JSON that chrome://tracing and https://ui.perfetto.dev
open directly: one process, thread 0 for the engine ("tick" and "call"
spans as complete "X" events), one thread per cache slot carrying that
slot's occupancy intervals (rendered as "rid<N>" spans) and lifecycle
instants. Wall microseconds map straight onto the trace clock; engine
ticks ride along in every event's ``args`` so the two clocks stay
cross-referencable inside the viewer.

Slot intervals are recorded in TICKS (they come from the scheduler's
audit log, which has no wall clock), so the converter rebuilds their
wall extent from the tick spans: an interval [admit, release) spans from
the start of the admit tick's span to the END of tick release-1's span.
"""

from __future__ import annotations

from typing import Dict, List

_ENGINE_TID = 0


def _thread_meta(tid: int, name: str) -> dict:
    return {"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def to_chrome_trace(records: List[dict]) -> dict:
    """Trace Event Format dict ({"traceEvents": [...]}) from obs.trace
    records (as produced by Tracer.records / obs.trace.load)."""
    events: List[dict] = [_thread_meta(_ENGINE_TID, "engine")]
    meta = records[0] if records and records[0].get("type") == "meta" else {}
    if meta.get("arch"):
        events.append({"ph": "M", "pid": 0, "name": "process_name",
                       "args": {"name": f"serve:{meta['arch']}"}})

    # tick -> (start_us, end_us), for mapping tick-clock intervals to wall
    tick_bounds: Dict[int, tuple] = {}
    for r in records:
        if r.get("type") == "span" and r.get("name") == "tick" \
                and r.get("dur_us") is not None:
            tick_bounds[r["tick"]] = (r["ts_us"], r["ts_us"] + r["dur_us"])

    slots_seen = set()
    for r in records:
        t = r.get("type")
        if t == "span":
            name = r["name"]
            if name == "call":
                name = f"call:{r['attrs'].get('kind', '?')}"
            events.append({
                "ph": "X", "pid": 0, "tid": _ENGINE_TID, "name": name,
                "cat": r["name"], "ts": r["ts_us"],
                "dur": r["dur_us"] if r["dur_us"] is not None else 0.0,
                "args": {"tick": r["tick"], **r["attrs"]}})
        elif t == "event":
            slot = r["attrs"].get("slot")
            tid = _ENGINE_TID if slot is None else int(slot) + 1
            if slot is not None:
                slots_seen.add(int(slot))
            events.append({
                "ph": "i", "pid": 0, "tid": tid, "name": r["name"],
                "cat": "lifecycle", "ts": r["ts_us"],
                "s": "t" if slot is not None else "p",
                "args": {"tick": r["tick"], **r["attrs"]}})
        elif t == "interval":
            if not tick_bounds:
                continue                  # tickless trace: nothing to map to
            slots_seen.add(r["slot"])
            last_tick = max(tick_bounds)
            admit = min(max(r["admit_tick"], min(tick_bounds)), last_tick)
            rel = r["release_tick"]
            # [admit, release) in ticks: end at the END of tick release-1
            # (an open interval runs to the end of the trace)
            end_tick = last_tick if rel is None \
                else min(max(rel - 1, admit), last_tick)
            ts = tick_bounds[admit][0]
            events.append({
                "ph": "X", "pid": 0, "tid": r["slot"] + 1,
                "name": f"rid{r['rid']}", "cat": "slot", "ts": ts,
                "dur": max(tick_bounds[end_tick][1] - ts, 0.0),
                "args": {"rid": r["rid"], "admit_tick": r["admit_tick"],
                         "release_tick": r["release_tick"]}})
    for s in sorted(slots_seen):
        events.append(_thread_meta(s + 1, f"slot{s}"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
