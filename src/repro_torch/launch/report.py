"""Render a serving-engine trace (launch.serve --trace-out) as text.

    PYTHONPATH=src python -m repro_torch.launch.report trace.jsonl
    PYTHONPATH=src python -m repro_torch.launch.report trace.jsonl \
        --chrome trace_chrome.json   # open in ui.perfetto.dev

Port of ``repro.launch.report``: the same sections from the same records,
the port's serve CLI embedding one waterfall record per call kind.

Sections (each reads one record type of the obs.trace taxonomy):

  * TIMELINE   — per-call-kind span latency (count, total, p50/p95 from
    the recorded dur_us) plus engine-tick stats;
  * SLOTS      — per-slot occupancy bars from the closed SlotIntervals
    (the engine's audit log), busy fraction per slot and overall;
  * QUEUE      — queue-depth-over-time sparkline from the tick spans'
    queue_depth attr;
  * PAGE POOL  — page-pool occupancy sparkline from the tick spans'
    pages_used / pages_total attrs (paged engines only);
  * WATERFALL  — per-call-kind weight-traffic attribution by parameter
    path (rows sum to the call's weight_bytes exactly);
  * FAULTS     — fault / retry / quarantine / replay / preempt / shed /
    reject events grouped by kind, with the tick each fired on.

The trace is validated (obs.trace.validate) before rendering — a trace
that fails its structural invariants is a bug report, not a report.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List

from repro_torch.obs.chrome import to_chrome_trace
from repro_torch.obs.trace import load, validate

#: sparkline glyphs, lowest to highest occupancy
_BARS = " .:-=+*#%@"


def _spark(values: List[float], vmax: float) -> str:
    if vmax <= 0:
        return "".join(" " for _ in values)
    out = []
    for v in values:
        i = min(int(v / vmax * (len(_BARS) - 1) + 0.5), len(_BARS) - 1)
        out.append(_BARS[i])
    return "".join(out)


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024 or unit == "GB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b:.0f} B"
        b /= 1024
    return f"{b:.1f} GB"


def render(records: List[dict], width: int = 64) -> str:
    stats = validate(records)
    meta = records[0]
    spans = [r for r in records if r.get("type") == "span"]
    events = [r for r in records if r.get("type") == "event"]
    intervals = [r for r in records if r.get("type") == "interval"]
    waterfalls = [r for r in records if r.get("type") == "waterfall"]
    ticks = [r for r in spans if r["name"] == "tick"]
    calls = [r for r in spans if r["name"] == "call"]
    lines: List[str] = []

    head = {k: v for k, v in meta.items() if k not in ("type", "version")}
    lines.append(f"trace v{meta['version']}  {head}")
    lines.append(f"records: {stats['spans']} spans, {stats['events']} "
                 f"events, {stats['intervals']} intervals, "
                 f"{stats['waterfalls']} waterfalls")

    # -- TIMELINE ----------------------------------------------------------
    lines.append("")
    lines.append("== TIMELINE ==")
    if ticks:
        durs = sorted(t["dur_us"] / 1e3 for t in ticks)
        total_ms = sum(durs)
        lines.append(f"{len(ticks)} ticks over {total_ms:.1f} ms wall  "
                     f"(tick p50={_percentile(durs, 0.5):.2f} "
                     f"p95={_percentile(durs, 0.95):.2f} ms)")
    by_kind: Dict[str, List[dict]] = defaultdict(list)
    for c in calls:
        tag = c["attrs"].get("kind", "?")
        if c["attrs"].get("replay"):
            tag += "+replay"
        by_kind[tag].append(c)
    for kind in sorted(by_kind):
        cs = by_kind[kind]
        durs = sorted(c["dur_us"] / 1e3 for c in cs)
        occ = [c["attrs"].get("occupancy") for c in cs]
        occ = [o for o in occ if o is not None]
        occ_s = (f"  occupancy mean={sum(occ) / len(occ):.2f}"
                 if occ else "")
        lines.append(f"  {kind:<28} {len(cs):>5} calls  "
                     f"p50={_percentile(durs, 0.5):.2f} "
                     f"p95={_percentile(durs, 0.95):.2f} ms  "
                     f"total={sum(durs):.1f} ms{occ_s}")

    # -- SLOTS -------------------------------------------------------------
    if intervals and ticks:
        n_ticks = max(t["tick"] for t in ticks) + 1
        lines.append("")
        lines.append("== SLOTS ==")
        by_slot: Dict[int, List[dict]] = defaultdict(list)
        for iv in intervals:
            by_slot[iv["slot"]].append(iv)
        n_cells = min(n_ticks, width)
        scale = n_ticks / n_cells          # ticks per display cell
        busy_total = 0
        for slot in sorted(by_slot):
            cells = [0.0] * n_cells
            busy = 0
            for iv in by_slot[slot]:
                end = iv["release_tick"] if iv["release_tick"] is not None \
                    else n_ticks
                busy += end - iv["admit_tick"]
                for t in range(iv["admit_tick"], min(end, n_ticks)):
                    c = min(int(t / scale), len(cells) - 1)
                    cells[c] += 1.0 / max(scale, 1.0)
            busy_total += busy
            lines.append(f"  slot {slot}  [{_spark(cells, 1.0)}]  "
                         f"busy {busy}/{n_ticks} "
                         f"({busy / n_ticks:.0%}, "
                         f"{len(by_slot[slot])} requests)")
        n_slots = max(by_slot) + 1
        lines.append(f"  overall busy fraction: "
                     f"{busy_total / (n_ticks * n_slots):.2f} "
                     f"over {n_slots} slots")

    # -- QUEUE -------------------------------------------------------------
    depths = [(t["tick"], t["attrs"].get("queue_depth", 0)) for t in ticks]
    if depths:
        lines.append("")
        lines.append("== QUEUE DEPTH ==")
        vals = [d for _, d in depths]
        vmax = max(vals)
        # bucket ticks down to the display width (mean depth per bucket)
        if len(vals) > width:
            per = len(vals) / width
            vals = [sum(vals[int(i * per):int((i + 1) * per)]) /
                    max(len(vals[int(i * per):int((i + 1) * per)]), 1)
                    for i in range(width)]
        lines.append(f"  [{_spark(vals, max(vmax, 1))}]  "
                     f"max={vmax}  mean={sum(d for _, d in depths) / len(depths):.2f}  "
                     f"(tick 0..{depths[-1][0]})")

    # -- PAGE POOL ---------------------------------------------------------
    pool = [(t["tick"], t["attrs"].get("pages_used"),
             t["attrs"].get("pages_total")) for t in ticks
            if t["attrs"].get("pages_total")]
    if pool:
        lines.append("")
        lines.append("== PAGE POOL ==")
        total = max(pt for _, _, pt in pool)
        vals = [float(pu) for _, pu, _ in pool]
        vmax = max(vals)
        full_ticks = sum(1 for v in vals if v >= total)
        mean = sum(vals) / len(vals)
        if len(vals) > width:
            per = len(vals) / width
            vals = [sum(vals[int(i * per):int((i + 1) * per)]) /
                    max(len(vals[int(i * per):int((i + 1) * per)]), 1)
                    for i in range(width)]
        lines.append(f"  [{_spark(vals, total)}]  "
                     f"pool {total} pages  max_used={vmax:.0f} "
                     f"mean={mean:.2f}  full {full_ticks}/{len(pool)} "
                     f"ticks")

    # -- WATERFALL ---------------------------------------------------------
    if waterfalls:
        lines.append("")
        lines.append("== WEIGHT-TRAFFIC WATERFALL (bytes / device call) ==")
        for wf in waterfalls:
            lines.append(f"  {wf['kind']}  total {_fmt_bytes(wf['total'])}")
            rows = sorted(wf["rows"].items(), key=lambda kv: -kv[1])
            top = max((v for _, v in rows), default=1.0)
            for path, b in rows:
                bar = "#" * max(int(b / top * 28), 1)
                lines.append(f"    {path:<36} {_fmt_bytes(b):>10}  "
                             f"{b / wf['total']:>6.1%}  {bar}")
            resid = wf["total"] - sum(wf["rows"].values())
            if resid:
                lines.append(f"    (!) rows - total residual: {resid}")

    # -- FAULTS ------------------------------------------------------------
    fault_names = ("fault", "retry", "quarantine", "replay", "preempt",
                   "shed", "reject")
    fevents = [e for e in events if e["name"] in fault_names]
    if fevents:
        lines.append("")
        lines.append("== FAULTS / RECOVERY ==")
        grouped: Dict[str, List[dict]] = defaultdict(list)
        for e in fevents:
            key = e["name"]
            sub = e["attrs"].get("kind") or e["attrs"].get("reason")
            if sub:
                key += f"[{sub}]"
            grouped[key].append(e)
        for key in sorted(grouped):
            es = grouped[key]
            tks = [e["tick"] for e in es]
            show = ", ".join(str(t) for t in tks[:12])
            more = f", +{len(tks) - 12} more" if len(tks) > 12 else ""
            lines.append(f"  {key:<28} {len(es):>4}x  "
                         f"ticks [{show}{more}]")
        replays = [e for e in events if e["name"] == "replay"]
        if replays:
            by_rid: Dict[int, int] = defaultdict(int)
            for e in replays:
                by_rid[e["attrs"]["rid"]] += 1
            att = ", ".join(f"req{r}: {n}" for r, n in sorted(by_rid.items()))
            lines.append(f"  replay attribution: {att}")

    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a serving-engine JSONL trace "
                    "(launch.serve --trace-out) as text.")
    ap.add_argument("trace", help="JSONL trace file")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="also write a Chrome/Perfetto trace "
                         "(open at ui.perfetto.dev)")
    ap.add_argument("--width", type=int, default=64,
                    help="sparkline/occupancy-bar width in characters")
    args = ap.parse_args(argv)

    records = load(args.trace)
    sys.stdout.write(render(records, width=args.width))
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(to_chrome_trace(records), f)
        print(f"[report] chrome trace -> {args.chrome} "
              f"(open at ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
