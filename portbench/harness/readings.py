"""What the per-layer readers read: the window's stamps, the engine's
tracer records (its "tick" and "call" spans and "admit" events, on the
host clock), each tick's work and the device window, with the helpers the
readers share."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from portbench.harness import peaks, stats
from portbench.harness.cost import Costs


@dataclass
class Run:
    win: object                 # drive.Window
    costs: Costs
    slots: int
    chunk: int
    records: list               # the engine tracer's records
    trace_t0: float             # the tracer's clock zero on the host clock
    joint_symbols: tuple
    attention_symbols: tuple

    # -- the window ------------------------------------------------------
    def in_window(self, t: float) -> bool:
        return self.win.w0 <= t <= self.win.w1

    def due_in_window(self):
        return [r for r in self.win.reqs if self.in_window(r.due)]

    def spans(self, name: str, **attrs):
        """(start, seconds, attrs) of the tracer's spans called ``name``
        whose attrs hold ``attrs``, started inside the window."""
        out = []
        for r in self.records:
            if r.get("type") != "span" or r.get("name") != name or \
                    r.get("dur_us") is None:
                continue
            a = r.get("attrs", {})
            if any(a.get(k) != v for k, v in attrs.items()):
                continue
            t = self.trace_t0 + r["ts_us"] * 1e-6
            if self.in_window(t):
                out.append((t, r["dur_us"] * 1e-6, a))
        return out

    def mean_call_ms(self, phase: str) -> Optional[float]:
        calls = self.spans("call", phase=phase)
        if not calls:
            return None
        return 1e3 * sum(d for _, d, _ in calls) / len(calls)

    def admit_tick(self) -> dict:
        return {r["attrs"]["rid"]: r["tick"] for r in self.records
                if r.get("type") == "event" and r.get("name") == "admit"}

    # -- the device window -------------------------------------------------
    def device(self):
        d = self.win.device
        return d if d is not None and d.window_s else None

    def profiled_work(self):
        lo, hi = self.win.prof_ticks or (0, 0)
        return [self.win.work[t] for t in range(lo, hi) if t in self.win.work]

    def idle_pct(self) -> Optional[float]:
        d = self.device()
        if d is None:
            return None
        return 100.0 * (1.0 - d.busy_s / d.window_s)

    def mfu_pct(self) -> Optional[float]:
        ops = 0.0
        for tno, _, t1 in self.win.ticks:
            if not self.in_window(t1) or tno not in self.win.work:
                continue
            decode, chunk, n_gen = self.win.work[tno]
            ops += sum(self.costs.span_ops(p, 1) for p in decode)
            ops += sum(self.costs.span_ops(s, n) for s, n in chunk)
            ops += n_gen * self.costs.unembed_ops()
        if not ops:
            return None
        return 100.0 * ops / ((self.win.w1 - self.win.w0) * peaks.BF16_FLOPS)


def percentile_ms(values, p):
    v = stats.percentile(values, p)
    return None if v is None else 1e3 * v
