"""The measured window: the harness's own loop around the port's
``ServeEngine.submit`` and ``tick``.

A request is due at its scheduled time (open loop) or when its client's
previous request completed (closed loop); it is submitted at the first
loop turn at or after that, with ``arrival = engine.tick_count``. Every
``tick()`` ends with the logits on the host, so the stamp taken after it
is when its tokens exist; ``engine.outputs`` says which requests gained
tokens. After the window closes no request is submitted unless it was due
inside it, and the engine ticks on until every request due in the window
has its first token (at most ``DRAIN_S``), so no time to first token is
cut short.

With ``traced`` the loop also records each tick's work (the positions the
decode call and the chunk call processed, from the engine's slots) for
the cost functions, and runs torch.profiler over the whole ticks of the
window's last seconds (``DeviceWindow``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from portbench.harness.traffic import Req, Stream

DRAIN_S = 60.0
#: the traced stretch: the window's last PROFILE_S seconds (a fifth of a
#: shorter window), closed at the first tick boundary after the window, so
#: reading the profiler's records never stalls the window
PROFILE_S = 1.5
WARMUP_RID = 1 << 40


@dataclass
class Window:
    w0: float
    w1: float
    reqs: List[Req]
    ticks: list = field(default_factory=list)     # (tick, start, end)
    #: tick -> (decode positions, chunk (start, n) per slot, tokens made)
    work: dict = field(default_factory=dict)
    device: Optional[object] = None               # profile.DeviceWindow
    prof_ticks: tuple = ()
    drain_s: float = 0.0


def _request(req: Req, arrival: int):
    from repro_torch.serving.workload import Request
    return Request(rid=req.index, prompt=req.prompt, gen_len=req.gen_len,
                   arrival=arrival)


def warm_up(engine, vocab: int, chunk: int):
    """Capture every step the window uses (decode, prefill chunk, reset)
    and replay each a few times: two requests whose prompts take two
    chunks, decoding four tokens."""
    from repro_torch.serving.workload import Request
    rng = np.random.default_rng(0)
    for i in range(2):
        prompt = rng.integers(1, vocab, size=chunk + 1).astype(np.int32)
        engine.submit(Request(rid=WARMUP_RID + i, prompt=prompt, gen_len=4,
                              arrival=engine.tick_count))
    while any(len(engine.outputs.get(WARMUP_RID + i, ())) < 4
              for i in range(2)):
        engine.tick()
    engine.tick()


class _Work:
    """Per-tick positions processed, read from the engine's slots: prompt
    positions by the cursor of each prefilling slot, a decode position for
    every generated token after the first."""

    def __init__(self, engine):
        self.engine = engine
        self.stepwise = engine.prefill_mode == "full"
        self.prompt_done = {}

    def tick(self, reqs, outputs, n_before):
        cursor = {s.rid: s.cursor for s in self.engine.slots
                  if s.rid is not None}
        decode, chunk, n_gen = [], [], 0
        for req in reqs:
            rid, P = req.index, len(req.prompt)
            n = len(outputs.get(rid, ()))
            done = P if n >= 1 else cursor.get(rid, 0)
            old = self.prompt_done.get(rid, 0)
            if done > old:
                if self.stepwise:
                    decode.extend(range(old, done))
                else:
                    chunk.append((old, done - old))
                self.prompt_done[rid] = done
            decode.extend(P + j - 1 for j in range(max(n_before[rid], 1), n))
            n_gen += n - n_before[rid]
        return decode, chunk, n_gen


def run(engine, stream: Stream, mix: dict, seconds: float, traced: bool,
        vocab: int, device_window=None) -> Window:
    clock = time.perf_counter
    closed = mix["loop"] == "closed"
    outputs = engine.outputs
    inflight = {}
    unslotted = {}      # admitted requests whose slot is not yet known
    reqs: List[Req] = []
    work = _Work(engine) if traced else None
    win = Window(0.0, 0.0, reqs)

    def submit(req: Req, now: float):
        req.submit = now
        reqs.append(req)
        if engine.submit(_request(req, engine.tick_count)):
            inflight[req.index] = req
            unslotted[req.index] = req
        else:
            req.rejected = True
            if closed:
                next_due[req.client] = now

    def tick():
        tno = engine.tick_count
        before = list(inflight.values())
        n_before = {r.index: r.n_out for r in before} if work else None
        t0 = clock()
        engine.tick()
        t1 = clock()
        win.ticks.append((tno, t0, t1))
        if unslotted:
            for s, slot in enumerate(engine.slots):
                req = unslotted.pop(slot.rid, None)
                if req is not None:
                    req.slot = s
        for rid in list(inflight):
            req = inflight[rid]
            n = len(outputs.get(rid, ()))
            if n > req.n_out:
                if req.n_out == 0:
                    req.first = t1
                req.stamps.append((t1, n - req.n_out))
                req.n_out = n
                if n >= req.gen_len:
                    req.done = t1
                    del inflight[rid]
                    unslotted.pop(rid, None)
                    if closed:
                        next_due[req.client] = t1
        if work is not None:
            win.work[tno] = work.tick(before, outputs, n_before)
        return t1

    n_clients = mix.get("clients", 0)
    next_j = [0] * n_clients
    w0 = clock()
    win.w0, win.w1 = w0, w0 + seconds
    if closed:
        next_due = [w0] * n_clients
        pending = []
    else:
        pending = [w0 + a for a in stream.arrivals(seconds)]
        next_due = None
    k = 0
    prof_at = win.w1 - min(PROFILE_S, 0.2 * seconds)
    profiling = False
    now = w0
    while now < win.w1:
        if closed:
            for c in range(n_clients):
                if next_due[c] is not None and next_due[c] <= now:
                    req = stream.closed(c, next_j[c])
                    req.due = next_due[c]
                    next_j[c] += 1
                    next_due[c] = None
                    submit(req, now)
        else:
            while k < len(pending) and pending[k] <= now:
                req = stream.request(k)
                req.due = pending[k]
                k += 1
                submit(req, now)
        if device_window is not None and not profiling and now >= prof_at:
            device_window.start()
            first = engine.tick_count
            profiling = True
        if inflight:
            now = tick()
        else:
            nxt = pending[k] if (not closed and k < len(pending)) else win.w1
            wait = min(nxt, win.w1) - clock()
            if wait > 1e-3:
                time.sleep(wait - 5e-4)
            now = clock()
    # -- drain: requests due in the window, to their first token ----------
    t_close = clock()
    if closed:
        for c in range(n_clients):
            if next_due[c] is not None and next_due[c] <= win.w1:
                req = stream.closed(c, next_j[c])
                req.due = next_due[c]
                next_j[c] += 1
                submit(req, t_close)
    else:
        while k < len(pending) and pending[k] <= win.w1:
            req = stream.request(k)
            req.due = pending[k]
            k += 1
            submit(req, t_close)
    if profiling:
        # after the window's last submissions: reading the records takes
        # seconds no request of the window waits on to be submitted
        device_window.stop()
        win.prof_ticks = (first, engine.tick_count)
    while any(r.first is None for r in inflight.values()
              if r.due <= win.w1) and clock() - t_close < DRAIN_S:
        tick()
    win.drain_s = clock() - t_close
    if device_window is not None:
        win.device = device_window
    return win
