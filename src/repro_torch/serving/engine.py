"""Request-level serving engine: admission queue + per-slot state machine
+ fixed-shape steps.

Port of the FIFO, contiguous-cache subset of ``repro.serving.engine``,
with both prefill modes. The engine owns a static batch of ``n_slots``
cache slots; each request moves through

    QUEUED -> PREFILLING -> DECODING -> DONE

with all scheduling on the host and all math in two fixed-shape steps
(``launch.steps.build_step``) plus the slot reset:

  * decode step   (B, 1) tokens + (B,) active mask (only active slots
    write the cache: models.decode.decode_step_);
  * prefill chunk (B, C) tokens + (B,) n_valid (models.decode_chunk_),
    in prefill_mode "chunked" only: in "full" mode (and for
    sliding-window archs, which cannot chunk) prompt tokens ride the
    decode step one at a time and no chunk step is built;
  * slot reset    zeroes a freed slot's cache slice and position before
    admission (models.decode.reset_slots_).

Each step is compiled once (``launch.steps.compile_step``, the
reference's ``jax.jit`` with the cache donated): on the card one CUDA
graph per step kind, captured at its first call and replayed after, with
the cache updated in place; on the CPU the same in-place steps run
eagerly. The recompile sentinel (``obs.sentinel``) holds each step to one
compiled signature and is checked at the end of every tick.

One engine TICK = admit -> (prefill chunk, if any slot is prefilling and
the mode is "chunked") -> (decode step, if any slot is decoding, or
prefilling in "full" mode): prefilling a new request never stalls
in-flight decodes. Tick accounting and the slot state machine are
the reference's; its fault tolerance, tracing, journal, snapshots,
paging, SPF admission and SLO shedding are not ported yet and the
constructor refuses them.

The host-side argmax of every call's logits synchronises the device each
tick, as the reference's ``np.asarray`` does; per-call latencies are
measured through that copy, so they include the device time. A compiled
step's logits are valid until its next call: the engine copies them to
the host before that.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_step, compile_step
from repro_torch.models import init_cache
from repro_torch.obs.sentinel import RecompileSentinel
from repro_torch.serving.metrics import MetricsRecorder
from repro_torch.serving.prefill import PREFILL_MODES, assemble_chunk
from repro_torch.serving.workload import Request


class SlotState(enum.Enum):
    FREE = "free"
    PREFILLING = "prefilling"
    DECODING = "decoding"


@dataclass
class _Slot:
    state: SlotState = SlotState.FREE
    rid: Optional[int] = None
    prompt: Optional[np.ndarray] = None
    cursor: int = 0                      # prompt tokens already in cache
    gen_len: int = 0
    pending_token: int = 0               # next decode input


@dataclass
class SlotInterval:
    """Audit record: slot s served rid from admit_tick until release_tick
    (exclusive)."""
    slot: int
    rid: int
    admit_tick: int
    release_tick: Optional[int] = None


class ServeEngine:
    """See module docstring. Typical use:

        engine = ServeEngine(cfg, params, n_slots=4, max_len=64,
                             prefill_chunk=16, stacked_tables=tables)
        results = engine.run(make_trace(spec, cfg.vocab_size))
        print(engine.metrics.summary())
    """

    def __init__(self, cfg, params, *, n_slots: int = 4, max_len: int = 64,
                 prefill_chunk: int = 16, prefill_mode: str = "chunked",
                 schedule: str = "fifo",
                 stacked_tables=None, max_ticks: int = 100_000,
                 device="cuda", paged: bool = False, fault_plan=None,
                 journal=None, snapshot_dir: Optional[str] = None,
                 tracer=None, deadline_slack: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 recompile_sentinel: bool = True, cuda_graphs: bool = True):
        unported = {"paged": paged, "fault_plan": fault_plan,
                    "journal": journal, "snapshot_dir": snapshot_dir,
                    "tracer": tracer, "deadline_slack": deadline_slack,
                    "queue_cap": queue_cap}
        for name, val in unported.items():
            if val:
                raise NotImplementedError(f"{name} is not ported yet")
        if schedule != "fifo":
            raise NotImplementedError(f"schedule={schedule!r} is not ported "
                                      f"yet (fifo only)")
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                             f"{PREFILL_MODES}")
        if prefill_mode == "chunked" and \
                not cfg.serving_capabilities().chunked_prefill:
            # sliding-window archs: the ring cache needs stepwise writes
            prefill_mode = "full"
        self.prefill_mode = prefill_mode
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.max_ticks = max_ticks
        self.params = params

        cache = init_cache(cfg, n_slots, max_len, device=self.device)
        # per-slot positions from the start
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        if "attn" in cache and "pos" in cache["attn"]:
            cache["attn"]["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                               device=self.device)
        self.cache = cache
        # the three steps, compiled once each with the params and the cache
        # held where they lie (cuda_graphs=False runs them eagerly on the
        # card too, counting signatures all the same)
        def compiled(kind, buffers):
            return compile_step(build_step(cfg, kind,
                                           stacked_tables=stacked_tables),
                                buffer_argnums=buffers, graphs=cuda_graphs)
        self._decode = compiled("decode", (0, 1))
        self._prefill = (compiled("prefill_chunk", (0, 1))
                         if prefill_mode == "chunked" else None)
        self._reset = compiled("reset", (0,))
        # the chunk math of the prefill step; None in "full" mode, where
        # prompt tokens ride the decode call
        self.prefill_kind = (self._prefill.call_kind
                             if self._prefill is not None else None)

        # the fixed-shape no-recompile contract, enforced: each compiled
        # step gets ONE signature; check() runs every tick (obs.sentinel)
        self.sentinel = None
        if recompile_sentinel:
            self.sentinel = RecompileSentinel()
            for step in (self._decode, self._prefill, self._reset):
                if step is not None:
                    self.sentinel.register(
                        RecompileSentinel.key(step.call_kind, cfg.name), step)

        self.queue: deque = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.tick_count = 0
        self.outputs: Dict[int, List[int]] = {}
        #: rid -> the (1, V) logits row of its first token, a CPU tensor in
        #: the model's logits dtype (the reference keeps np.asarray of the
        #: same row; numpy has no bf16)
        self.first_logits: Dict[int, torch.Tensor] = {}
        self.rejected: Dict[int, str] = {}
        self.slot_log: List[SlotInterval] = []
        self._open_interval: Dict[int, SlotInterval] = {}
        self.metrics = MetricsRecorder()

    # ------------------------------------------------------------------ API

    def submit(self, request: Request) -> bool:
        """Queue a request; returns False if it was REJECTED instead
        (oversized or a duplicate rid; recorded, never raised)."""
        if request.deadline is not None:
            raise NotImplementedError("request deadlines (SLO shedding) are "
                                      "not ported yet")
        reason = None
        if request.rid in self.metrics.requests:
            reason = "duplicate_rid"
        elif request.prompt_len + request.gen_len > self.max_len:
            reason = "oversized"
        if reason is not None:
            if reason != "duplicate_rid":
                self.rejected[request.rid] = reason
            self.metrics.on_reject(request.rid, request.prompt_len,
                                   request.gen_len, request.arrival, reason)
            return False
        self.queue.append(request)
        self.metrics.on_submit(request.rid, request.prompt_len,
                               request.gen_len, request.arrival)
        return True

    def run(self, requests: List[Request]):
        """Serve a trace to completion; returns {rid: generated tokens}."""
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(r)
        self.metrics.start()
        while self.queue or any(s.state is not SlotState.FREE
                                for s in self.slots):
            self.tick()
            if self.tick_count > self.max_ticks:
                raise RuntimeError(f"engine exceeded max_ticks="
                                   f"{self.max_ticks}; scheduler stuck?")
        self.metrics.record_slot_log(
            [(iv.slot, iv.admit_tick, iv.release_tick)
             for iv in self.slot_log], self.n_slots)
        self.metrics.stop()
        return self.outputs

    # ------------------------------------------------------------- one tick

    def tick(self):
        tick = self.tick_count
        self._admit(tick)
        calls = 0
        if self.prefill_mode == "chunked":
            calls += self._prefill_phase(tick)
        calls += self._decode_phase(tick)
        self.metrics.on_tick(
            tick, queue_depth=len(self.queue),
            n_prefilling=sum(s.state is SlotState.PREFILLING
                             for s in self.slots),
            n_decoding=sum(s.state is SlotState.DECODING for s in self.slots),
            device_calls=calls)
        self.tick_count += 1
        if self.sentinel is not None:
            self.sentinel.check()

    # -------------------------------------------------------------- phases

    def _pop_next(self, tick: int):
        """FIFO: the queue head once it has arrived, else None."""
        if self.queue and self.queue[0].arrival <= tick:
            return self.queue.popleft()
        return None

    def _admit(self, tick: int):
        """QUEUED -> PREFILLING: pop arrived requests into free slots and
        zero the slots' stale cache slices."""
        mask = np.zeros((self.n_slots,), bool)
        for s, slot in enumerate(self.slots):
            if slot.state is not SlotState.FREE:
                continue
            req = self._pop_next(tick)
            if req is None:
                break
            self.slots[s] = _Slot(state=SlotState.PREFILLING, rid=req.rid,
                                  prompt=np.asarray(req.prompt, np.int32),
                                  gen_len=req.gen_len)
            mask[s] = True
            self.outputs[req.rid] = []
            self.metrics.on_admit(req.rid, tick)
            iv = SlotInterval(slot=s, rid=req.rid, admit_tick=tick)
            self.slot_log.append(iv)
            self._open_interval[s] = iv
        if mask.any():
            self.cache = self._reset(self.cache, self._tensor(mask))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _host_logits(self, logits) -> np.ndarray:
        """Host-side (B, V) f32 logits for argmax and the finite check."""
        return logits[:, 0, :].float().cpu().numpy()

    def _prefill_phase(self, tick: int) -> int:
        prefilling = {s: slot.prompt for s, slot in enumerate(self.slots)
                      if slot.state is SlotState.PREFILLING}
        if not prefilling:
            return 0
        cursors = {s: self.slots[s].cursor for s in prefilling}
        tokens, n_valid = assemble_chunk(prefilling, cursors, self.n_slots,
                                         self.prefill_chunk)
        c0 = time.monotonic()
        logits, self.cache = self._prefill(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(n_valid))
        lg = self._host_logits(logits)
        self.metrics.on_device_call("prefill", kind=self.prefill_kind,
                                    dur_s=time.monotonic() - c0)
        nxt = lg.argmax(axis=-1)
        for s in prefilling:
            if not np.isfinite(lg[s]).all():
                raise FloatingPointError(f"slot {s}: non-finite logits in "
                                         f"prefill at tick {tick}")
            slot = self.slots[s]
            slot.cursor += int(n_valid[s])
            self.metrics.on_prefill_step(slot.rid)
            if slot.cursor >= len(slot.prompt):
                # the chunk holding the last prompt token yields the first
                # generated token: TTFT lands here
                self._finish_prefill(s, int(nxt[s]),
                                    logits[s].to("cpu", copy=True), tick)
        return 1

    def _decode_phase(self, tick: int) -> int:
        """One decode step over the decoding slots and, in "full" mode,
        the prefilling ones, each feeding its next prompt token."""
        stepwise_prefill = self.prefill_mode == "full"
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for s, slot in enumerate(self.slots):
            if slot.state is SlotState.DECODING:
                tokens[s, 0] = slot.pending_token
                active[s] = True
            elif stepwise_prefill and slot.state is SlotState.PREFILLING:
                tokens[s, 0] = slot.prompt[slot.cursor]
                active[s] = True
        if not active.any():
            return 0
        c0 = time.monotonic()
        logits, self.cache = self._decode(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(active))
        lg = self._host_logits(logits)
        self.metrics.on_device_call("decode", kind="decode",
                                    dur_s=time.monotonic() - c0)
        nxt = lg.argmax(axis=-1)
        for s, slot in enumerate(self.slots):
            if not active[s]:
                continue
            if not np.isfinite(lg[s]).all():
                raise FloatingPointError(f"slot {s}: non-finite logits in "
                                         f"decode at tick {tick}")
            if slot.state is SlotState.PREFILLING:
                slot.cursor += 1
                self.metrics.on_prefill_step(slot.rid)
                if slot.cursor >= len(slot.prompt):
                    self._finish_prefill(s, int(nxt[s]),
                                         logits[s].to("cpu", copy=True), tick)
                continue
            tok = int(nxt[s])
            self.outputs[slot.rid].append(tok)
            slot.pending_token = tok
            self.metrics.on_token(slot.rid)
            if len(self.outputs[slot.rid]) >= slot.gen_len:
                self._release(s, tick)
        return 1

    # ------------------------------------------------------------- helpers

    def _finish_prefill(self, s: int, token: int, logits: torch.Tensor,
                        tick: int):
        slot = self.slots[s]
        slot.state = SlotState.DECODING
        slot.pending_token = token
        self.outputs[slot.rid].append(token)
        self.first_logits[slot.rid] = logits
        self.metrics.on_first_token(slot.rid, tick)
        self.metrics.on_token(slot.rid)
        if len(self.outputs[slot.rid]) >= slot.gen_len:
            self._release(s, tick)

    def _release(self, s: int, tick: int):
        slot = self.slots[s]
        self.metrics.on_done(slot.rid, tick)
        iv = self._open_interval.pop(s, None)
        if iv is not None:
            iv.release_tick = tick + 1
        self.slots[s] = _Slot()           # FREE; cache zeroed at next admit
