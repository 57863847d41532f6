"""Request-level serving engine: admission queue + per-slot state machine
+ fixed-shape steps.

Port of ``repro.serving.engine``, whole: a contiguous or paged cache,
both prefill modes, both admission orders, SLO shedding, fault
containment, tracing, the write-ahead journal and snapshots with
kill-and-restore. The engine owns a static batch of ``n_slots`` cache slots;
each request moves through

    QUEUED -> PREFILLING -> DECODING -> DONE

with all scheduling on the host and all math in two fixed-shape steps
(``launch.steps.build_slot_decode_step`` and
``serving.prefill.build_chunk_step``) plus the slot reset:

  * decode step   (B, 1) tokens + (B,) active mask (only active slots
    write the cache: models.decode.decode_step_);
  * prefill chunk (B, C) tokens + (B,) n_valid (models.decode_chunk_),
    in prefill_mode "chunked" only: in "full" mode (and for
    sliding-window archs, which cannot chunk) prompt tokens ride the
    decode step one at a time and no chunk step is built;
  * slot reset    zeroes a slot's cache slice and position before
    admission and at a quarantine (models.decode.reset_slots_).

An enc-dec model (whisper) takes ``enc_out``, the encoder's output with
one row per slot, into the cache: every step reads it, and it stays with
its slot whatever request the slot serves (the reference's rule).

The engine runs on a mesh (``mesh``, by default
``launch.mesh.make_test_mesh(device)``): the one-card (1, 1) mesh, whose
device must be ``device``. The steps' shardings are reckoned at the
engine's shapes and checked to fit it (``runtime.sharding``), and every
operand must lie on its device; nothing moves, as one card holds every
array whole. A mesh of more than one device, or on another device, is
refused.

Each step is compiled once (``launch.steps.compile_step``, the
reference's ``jax.jit`` with the cache donated): on the card one CUDA
graph per step kind, captured at its first call and replayed after, with
the cache updated in place; on the CPU the same in-place steps run
eagerly. The recompile sentinel (``obs.sentinel``) holds each step to one
compiled signature and is checked at the end of every tick.

One engine TICK = (cache faults of the fault plan) -> (slot shedding) ->
admit -> (prefill chunk, if any slot is prefilling and the mode is
"chunked") -> (decode step, if any slot is decoding, or prefilling in
"full" mode): prefilling a new request never stalls in-flight decodes.

Admission (``schedule``): "fifo" admits in arrival order; "spf" admits
the shortest ARRIVED prompt first, with starvation bounded by
``spf_age_cap``: every shortest-first pick raises the skip count of each
arrived request it passed over, and a request at the cap is urgent and
goes first (oldest arrival first; urgent picks raise no counts), so
``skips <= spf_age_cap`` always.

SLO shedding and admission control, all RECORDED (metrics.on_reject /
on_shed), never raised mid-trace (``strict=True`` raises ValueError for
an oversized or duplicate request instead): a bounded queue
(``queue_cap``) rejects at submit; a queued request whose optimistic
completion estimate overshoots its ``Request.deadline`` is shed before
it takes a slot; an in-flight one is shed the tick its deadline becomes
unreachable.

Fault containment (``fault_plan``, serving.faults; blast radius <= one
tick, recovery bitwise):

  * every device call runs under bounded retry (``max_step_retries``);
    past the budget every slot of the call is quarantined. With no plan
    installed a step's exception propagates unchanged;
  * a finite guard checks each participating slot's logits row on the
    host and fails only that slot (a NaN-poisoned cache surfaces there:
    detection by propagation);
  * a quarantined slot's token is dropped, its cache slices are zeroed
    by the compiled reset step, and it re-prefills its durable record
    (prompt + tokens emitted so far) in chunks: chunk == stepwise decode
    (bitwise on the card, within 1e-6 on the CPU; ``cfg.prefill_exact``
    for SSM stacks) makes the replayed stream the fault-free one. A
    request that faults more than ``max_replays`` times is shed
    ("fault_budget").

Every tick's wall time feeds a ``runtime.fault.StragglerMonitor``;
outlier ticks are counted in metrics ("straggler_ticks").

Tracing (``tracer=obs.Tracer()``) is PASSIVE: two-clock spans ("tick"
per tick, "call" per device call, closed after the host copy of the
call's logits), slot lifecycle events and the closed slot intervals;
with it on, the engine issues the same device calls and kernel launches
as with it off.

Durability (serving.journal, serving.snapshot), passive like the tracer:

  * ``journal=<path>`` appends a CRC-framed record for every
    request-visible transition (submit, admit, token, done, shed, reject,
    preempt), fsync'd once per tick; ``snapshot_dir`` + ``snapshot_every``
    write periodic atomic snapshots (the cache, the state machine, the
    queue, the metrics) through the checkpoint layer's tmp dir + fsync +
    ``os.replace``. Neither issues a device call.
  * ``ServeEngine.restore(cfg, params, snapshot_dir=..., journal_path=...)``
    rebuilds from the latest snapshot, copying its cache into the new
    engine's cache tensors, folds the journal tail over it and
    re-prefills each active slot's durable record on the replay path;
    ``resume()`` then continues the streams bitwise where the dead
    process left them (chunk == stepwise). Redone work is at most
    ``snapshot_every`` journal-evidenced tokens per active slot
    (``restore_stats["replayed_prefill_tokens"]``), metered under
    "<kind>+restore".
  * a FaultPlan ``engine_crash`` event kills the engine (EngineCrash)
    between ticks, after the tick's journal commit.

Paging (``paged=True``, serving.paging): the attention segments' k/v
live in a shared pool of ``n_pages`` pages of ``page_size`` positions,
and each step takes the allocator's page table as an operand (copied into
the compiled step's static buffer). Admission is gated on free pages for
the whole prompt (preempted requests first, FIFO); before the device
calls of a tick every slot grows to the pages its writes need, oldest
admission first, and page pressure preempts the youngest slot, which
re-enters later with its record (prompt + tokens so far) through the
replay path, bitwise. ``max_len % page_size`` must be 0, so a slot's
pages make the contiguous cache's length and paged attention is bitwise
the contiguous one.

The host-side argmax of every call's logits synchronises the device each
tick, as the reference's ``np.asarray`` does; per-call latencies are
measured through that copy, so they include the device time. A compiled
step's logits are valid until its next call: the engine copies them to
the host before that.
"""

from __future__ import annotations

import enum
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, concrete_device, make_test_mesh
from repro_torch.launch.steps import (build_slot_decode_step, build_step,
                                      compile_step)
from repro_torch.models import init_cache
from repro_torch.obs.sentinel import RecompileSentinel
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.serving.faults import (EngineCrash, FaultPlan, corrupt_cache,
                                       corrupt_logits)
from repro_torch.serving.journal import Journal
from repro_torch.serving.metrics import MetricsRecorder
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.prefill import (PREFILL_MODES, assemble_chunk,
                                         build_chunk_step, check_on_mesh)
from repro_torch.serving.workload import Request


class SlotState(enum.Enum):
    FREE = "free"
    PREFILLING = "prefilling"
    DECODING = "decoding"


@dataclass
class _Slot:
    state: SlotState = SlotState.FREE
    rid: Optional[int] = None
    prompt: Optional[np.ndarray] = None  # current prefill target (the
    #                                      replay record after a fault)
    durable: Optional[np.ndarray] = None  # original prompt, never mutated
    cursor: int = 0                      # prompt tokens already in cache
    gen_len: int = 0
    pending_token: int = 0               # next decode input
    deadline: Optional[float] = None
    fault_count: int = 0                 # quarantines charged to this slot
    replay: bool = False                 # prefilling a post-fault record
    #                                      (no first-token metrics again)
    restore: bool = False                # prefilling a warm-restart record
    #                                      (calls metered "+restore")
    admit_seq: int = -1                  # admission order: page pressure
    #                                      preempts the youngest by this


@dataclass
class _Preempted:
    """A request evicted from its slot under page pressure, waiting to
    re-enter. Its emitted tokens stay in ``engine.outputs``: re-admitted,
    it re-prefills ``durable + outputs[rid]`` and its stream continues
    bitwise."""
    rid: int
    durable: np.ndarray
    gen_len: int
    deadline: Optional[float]
    fault_count: int


@dataclass
class SlotInterval:
    """Audit record: slot s served rid from admit_tick until release_tick
    (exclusive)."""
    slot: int
    rid: int
    admit_tick: int
    release_tick: Optional[int] = None


class EngineStuckError(RuntimeError):
    """max_ticks exceeded: the scheduler wedged. Carries what a post-mortem
    needs: the outputs so far, the slot audit log, the metrics summary and
    the on-disk artifacts: the journal's path (committed before the raise)
    and, when the tracer knows its dump path, the trace dumped there."""

    def __init__(self, msg: str, *, outputs: Dict[int, List[int]],
                 slot_log: List[SlotInterval], summary: dict,
                 journal_path: Optional[str] = None,
                 trace_path: Optional[str] = None):
        super().__init__(msg)
        self.outputs = outputs
        self.slot_log = slot_log
        self.summary = summary
        self.journal_path = journal_path
        self.trace_path = trace_path


class ServeEngine:
    """See module docstring. Typical use:

        engine = ServeEngine(cfg, params, n_slots=4, max_len=64,
                             prefill_chunk=16, stacked_tables=tables)
        results = engine.run(make_trace(spec, cfg.vocab_size))
        print(engine.metrics.summary())
    """

    SCHEDULES = ("fifo", "spf")

    def __init__(self, cfg, params, *, mesh=None, n_slots: int = 4,
                 max_len: int = 64,
                 prefill_chunk: int = 16, prefill_mode: str = "chunked",
                 schedule: str = "fifo", spf_age_cap: int = 8,
                 stacked_tables=None, enc_out=None,
                 max_ticks: int = 100_000, strict: bool = False,
                 queue_cap: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 max_step_retries: int = 2, max_replays: int = 3,
                 tracer: Optional[Tracer] = None,
                 recompile_sentinel: bool = True,
                 journal=None, snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0, snapshot_keep: int = 2,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 device="cuda", cuda_graphs: bool = True):
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                             f"{PREFILL_MODES}")
        if schedule not in self.SCHEDULES:
            raise ValueError(f"schedule {schedule!r} not in "
                             f"{self.SCHEDULES}")
        if prefill_mode == "chunked" and \
                not cfg.serving_capabilities().chunked_prefill:
            # sliding-window archs: the ring cache needs stepwise writes
            prefill_mode = "full"
        self.prefill_mode = prefill_mode
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_test_mesh(self.device)
        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if self.mesh.device != concrete_device(self.device):
            raise ValueError(f"mesh on {self.mesh.device}, engine on "
                             f"{self.device}: the mesh's one device must be "
                             f"the engine's")
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.schedule = schedule
        self.spf_age_cap = spf_age_cap
        self.max_ticks = max_ticks
        self.strict = strict
        self.queue_cap = queue_cap
        self.fault_plan = fault_plan
        self.max_step_retries = max_step_retries
        self.max_replays = max_replays
        self.tracer = tracer
        self.params = params
        self.stacked_tables = stacked_tables
        # -- the paged cache: n_pages defaults to the full static capacity
        # (no oversubscription); fewer pages make page pressure preempt
        self.paged = bool(paged)
        if self.paged:
            if max_len % page_size != 0:
                raise ValueError(
                    f"paged engine needs max_len % page_size == 0 (got "
                    f"{max_len} % {page_size}): max_pages_per_slot * "
                    f"page_size == max_len makes paged decode bitwise the "
                    f"contiguous path")
            self.page_size = int(page_size)
            self.max_pages_per_slot = max_len // page_size
            self.n_pages = (int(n_pages) if n_pages is not None
                            else n_slots * self.max_pages_per_slot)
            self.page_alloc: Optional[PageAllocator] = PageAllocator(
                self.n_pages, n_slots, self.max_pages_per_slot,
                self.page_size)
        else:
            self.page_size = self.max_pages_per_slot = self.n_pages = 0
            self.page_alloc = None
        self._ptab_cached = None
        self._ptab_version = -1
        self.preempted: deque = deque()   # _Preempted, FIFO re-admission
        self._admit_seq = 0
        # -- durability: host-side only, so a journal or snapshots change
        # no device call and no stream
        if snapshot_every and not snapshot_dir:
            raise ValueError("snapshot_every set without snapshot_dir")
        self.journal: Optional[Journal] = (
            journal if isinstance(journal, Journal) or journal is None
            else Journal(str(journal)))
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.snapshot_keep = snapshot_keep
        self.restore_stats: Optional[dict] = None

        if cfg.is_encdec and (enc_out is None
                              or enc_out.shape[0] != n_slots):
            raise ValueError(f"{cfg.name} is enc-dec: pass enc_out, the "
                             f"encoder's output with one row per slot "
                             f"({n_slots}, Se, D) (models.encode)")
        cache = init_cache(cfg, n_slots, max_len, device=self.device,
                           enc_out=enc_out,
                           n_pages=self.n_pages if self.paged else None,
                           page_size=self.page_size if self.paged else None)
        # per-slot positions from the start
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        if "attn" in cache and "pos" in cache["attn"]:
            cache["attn"]["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                               device=self.device)
        self.cache = cache
        # the three steps, compiled once each with the params and the cache
        # held where they lie (cuda_graphs=False runs them eagerly on the
        # card too, counting signatures all the same); the decode and chunk
        # steps' shardings checked against the mesh at the engine's shapes
        decode_fn, shard_fn = build_slot_decode_step(
            cfg, self.mesh, stacked_tables=stacked_tables)
        inputs = (torch.zeros((n_slots, 1), dtype=torch.int32,
                              device=self.device),
                  torch.zeros((n_slots,), dtype=torch.bool,
                              device=self.device))
        if self.paged:
            inputs += (torch.full((n_slots, self.max_pages_per_slot), -1,
                                  dtype=torch.int32, device=self.device),)
        check_on_mesh(self.mesh, (params, cache) + inputs,
                      shard_fn(params, cache, *inputs),
                      ("params", "cache", "token", "active", "ptab"))
        self._decode = compile_step(decode_fn, buffer_argnums=(0, 1),
                                    graphs=cuda_graphs)
        self._prefill = None
        if prefill_mode == "chunked":
            self._prefill = build_chunk_step(
                cfg, self.mesh, params, cache, n_slots, prefill_chunk,
                stacked_tables=stacked_tables, paged=self.paged,
                max_pages=self.max_pages_per_slot, graphs=cuda_graphs)
        self._reset = compile_step(build_step(cfg, "reset"),
                                   buffer_argnums=(0,), graphs=cuda_graphs)
        # the chunk math of the prefill step; None in "full" mode, where
        # prompt tokens ride the decode call
        self.prefill_kind = (self._prefill.call_kind
                             if self._prefill is not None else None)

        # the fixed-shape no-recompile contract, enforced: each compiled
        # step gets ONE signature (quarantine resets reuse the reset
        # step's); check() runs every tick (obs.sentinel)
        self.sentinel = None
        if recompile_sentinel:
            self.sentinel = RecompileSentinel()
            for step in (self._decode, self._prefill, self._reset):
                if step is not None:
                    self.sentinel.register(
                        RecompileSentinel.key(step.call_kind, cfg.name), step)

        self.queue: deque = deque()
        self.skips: Dict[int, int] = {}   # QUEUED rid -> times jumped (spf);
        #                                   entries die at admission
        self.slots = [_Slot() for _ in range(n_slots)]
        self.tick_count = 0
        self.outputs: Dict[int, List[int]] = {}
        #: rid -> the (1, V) logits row of its first token, a CPU tensor in
        #: the model's logits dtype (the reference keeps np.asarray of the
        #: same row; numpy has no bf16)
        self.first_logits: Dict[int, torch.Tensor] = {}
        self.rejected: Dict[int, str] = {}   # rid -> rejection reason
        self.duplicate_rids: List[int] = []  # re-submitted rids (rejected
        #                                      without touching the
        #                                      original's row or outputs)
        self.slot_log: List[SlotInterval] = []
        self._open_interval: Dict[int, SlotInterval] = {}
        self._has_deadlines = False
        self.straggler = StragglerMonitor()
        self.metrics = MetricsRecorder()

    # ------------------------------------------------------------------ API

    def submit(self, request: Request) -> bool:
        """Queue a request; returns False if it was REJECTED instead
        (a duplicate rid, oversized, or the bounded queue is full).
        Rejections are recorded (metrics.on_reject, ``self.rejected`` /
        ``self.duplicate_rids``), never raised; ``strict=True`` raises
        ValueError for a duplicate or oversized request."""
        if request.rid in self.metrics.requests:
            if self.strict:
                raise ValueError(f"request {request.rid}: duplicate rid "
                                 f"(already submitted)")
            return self._reject(request, "duplicate_rid")
        total = request.prompt_len + request.gen_len
        # paged capacity: a slot backs at most max_pages_per_slot *
        # page_size tokens, and no request may need more pages than the
        # pool holds (admission could never satisfy it, and page-pressure
        # preemption would livelock trying)
        if self.paged:
            cap = self.max_pages_per_slot * self.page_size
            oversized = (total > cap or
                         self.page_alloc.pages_for(total) > self.n_pages)
        else:
            cap = self.max_len
            oversized = total > cap
        if oversized:
            if self.strict:
                raise ValueError(
                    f"request {request.rid}: prompt {request.prompt_len} + "
                    f"gen {request.gen_len} exceeds capacity {cap}"
                    + (f" (page pool {self.n_pages} pages)"
                       if self.paged else ""))
            return self._reject(request, "oversized")
        if self.queue_cap is not None and len(self.queue) >= self.queue_cap:
            return self._reject(request, "queue_full")
        self.queue.append(request)
        self.skips[request.rid] = 0
        if request.deadline is not None:
            self._has_deadlines = True
        self.metrics.on_submit(request.rid, request.prompt_len,
                               request.gen_len, request.arrival,
                               deadline=request.deadline)
        if self.journal is not None:
            self.journal.append(
                "submit", self.tick_count, rid=int(request.rid),
                prompt=[int(t) for t in request.prompt],
                gen_len=int(request.gen_len),
                arrival=float(request.arrival),
                deadline=(None if request.deadline is None
                          else float(request.deadline)))
        return True

    def _reject(self, request: Request, reason: str) -> bool:
        if reason == "duplicate_rid":
            # the rid's original request keeps its results entry
            self.duplicate_rids.append(request.rid)
        else:
            self.rejected[request.rid] = reason
        self.metrics.on_reject(request.rid, request.prompt_len,
                               request.gen_len, request.arrival, reason,
                               deadline=request.deadline)
        if self.journal is not None:
            self.journal.append(
                "reject", self.tick_count, rid=int(request.rid),
                reason=reason, prompt_len=int(request.prompt_len),
                gen_len=int(request.gen_len),
                arrival=float(request.arrival),
                deadline=(None if request.deadline is None
                          else float(request.deadline)))
        if self.tracer is not None:
            self.tracer.event("reject", self.tick_count, rid=request.rid,
                              reason=reason)
        return False

    def run(self, requests: List[Request]):
        """Serve a trace to completion; returns {rid: generated tokens} for
        every request that held a slot (rejected ones appear in
        ``self.rejected`` / metrics instead)."""
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(r)
        if self.journal is not None:
            self.journal.commit()   # the accepted trace is durable before
            #                         any serving work happens
        return self._serve_loop()

    def resume(self):
        """Continue serving after ``ServeEngine.restore``: the loop of
        run() without submitting anything (the queue and slots came from
        the snapshot and the journal tail; run() on a restored engine
        would reject every request as ``duplicate_rid``)."""
        return self._serve_loop()

    def _serve_loop(self):
        self.metrics.start()
        while self.queue or self.preempted or \
                any(s.state is not SlotState.FREE for s in self.slots):
            self.tick()
            if self.fault_plan is not None and \
                    self.fault_plan.crash_at(self.tick_count - 1):
                if self.tracer is not None:
                    self.tracer.event("crash", self.tick_count - 1)
                raise EngineCrash(f"injected engine crash after tick "
                                  f"{self.tick_count - 1}",
                                  tick=self.tick_count - 1)
            if self.tick_count > self.max_ticks:
                self._record_slot_log()
                self.metrics.stop()
                journal_path = trace_path = None
                if self.journal is not None:
                    self.journal.commit()
                    journal_path = self.journal.path
                if self.tracer is not None and self.tracer.path:
                    self.tracer.dump(self.tracer.path)
                    trace_path = self.tracer.path
                raise EngineStuckError(
                    f"engine exceeded max_ticks={self.max_ticks}; "
                    f"scheduler stuck?", outputs=dict(self.outputs),
                    slot_log=list(self.slot_log),
                    summary=self.metrics.summary(),
                    journal_path=journal_path, trace_path=trace_path)
        self._record_slot_log()
        self.metrics.stop()
        if self.journal is not None:
            self.journal.commit()
        return self.outputs

    def _record_slot_log(self):
        self.metrics.record_slot_log(
            [(iv.slot, iv.admit_tick, iv.release_tick)
             for iv in self.slot_log], self.n_slots)

    # ------------------------------------------------- durability layer

    def save_snapshot(self) -> str:
        """Write one atomic engine snapshot (serving.snapshot): called
        every ``snapshot_every`` ticks, or by hand between ticks. A host
        copy of the cache and host state only: no device call, so
        snapshots never move a stream."""
        from repro_torch.serving.snapshot import save_snapshot
        path = save_snapshot(self)
        if self.tracer is not None:
            self.tracer.event("snapshot", self.tick_count,
                              step=self.tick_count, path=path)
        return path

    @classmethod
    def restore(cls, cfg, params, *, snapshot_dir: str,
                journal_path: Optional[str] = None,
                step: Optional[int] = None, mesh=None, stacked_tables=None,
                enc_out=None, fault_plan: Optional[FaultPlan] = None,
                tracer: Optional[Tracer] = None,
                recompile_sentinel: bool = True, journal_fsync: bool = True,
                device="cuda", cuda_graphs: bool = True,
                **overrides) -> "ServeEngine":
        """A replacement engine from the latest (or ``step``) snapshot
        plus the journal tail: the warm restart after a crash.

        Geometry and policy knobs come from the snapshot's manifest;
        ``overrides`` may replace the policy ones, but the cache geometry
        must match or restore refuses (SnapshotError). The caller gives
        what is not durable state: cfg, params, tables, enc_out and the
        runtime objects (fault plan, tracer). The journal reopens in
        resume mode (its torn tail truncated) and appends after its last
        good record. Call ``resume()`` on the engine to continue;
        ``restore_stats`` carries the replay-work accounting."""
        from repro_torch.serving.snapshot import (read_snapshot_meta,
                                                  restore_engine_state)
        step, extra = read_snapshot_meta(snapshot_dir, step)
        kw = {k: extra["engine"][k] for k in
              ("n_slots", "max_len", "prefill_chunk", "prefill_mode",
               "schedule", "spf_age_cap", "max_ticks", "strict",
               "queue_cap", "max_step_retries", "max_replays",
               "snapshot_every", "snapshot_keep")}
        # the paged keys came with snapshot version 2
        kw["paged"] = extra["engine"].get("paged", False)
        if kw["paged"]:
            kw["page_size"] = extra["engine"]["page_size"]
            kw["n_pages"] = extra["engine"]["n_pages"]
        kw.update(overrides)
        engine = cls(cfg, params, mesh=mesh, stacked_tables=stacked_tables,
                     enc_out=enc_out, fault_plan=fault_plan, tracer=tracer,
                     recompile_sentinel=recompile_sentinel, journal=None,
                     snapshot_dir=snapshot_dir, device=device,
                     cuda_graphs=cuda_graphs, **kw)
        restore_engine_state(engine, snapshot_dir, step,
                             journal_path=journal_path,
                             journal_fsync=journal_fsync)
        return engine

    # ------------------------------------------------------------- one tick

    @torch.no_grad()
    def tick(self):
        t0 = time.monotonic()
        tick = self.tick_count
        span = (self.tracer.begin("tick", tick)
                if self.tracer is not None else None)
        calls = 0
        if self.fault_plan is not None:
            self._inject_cache_faults(tick)
        if self._has_deadlines:
            self._shed_hopeless_slots(tick)
        self._admit(tick)
        if self.paged:
            # every occupied slot owns the pages this tick's writes land in
            # before the device calls go out; pressure preempts the
            # youngest admission
            self._page_growth(tick)
            self.page_alloc.check()
        if self.prefill_mode == "chunked":
            calls += self._prefill_phase(tick)
        calls += self._decode_phase(tick)
        qd = len(self.queue)
        n_pre = sum(s.state is SlotState.PREFILLING for s in self.slots)
        n_dec = sum(s.state is SlotState.DECODING for s in self.slots)
        pages_used = pages_total = None
        if self.paged:
            pages_used = self.page_alloc.used_pages
            pages_total = self.n_pages
        self.metrics.on_tick(tick, queue_depth=qd, n_prefilling=n_pre,
                             n_decoding=n_dec, device_calls=calls,
                             pages_used=pages_used, pages_total=pages_total)
        if span is not None:
            attrs = dict(queue_depth=qd, n_prefilling=n_pre,
                         n_decoding=n_dec, device_calls=calls)
            if self.paged:
                attrs.update(pages_used=pages_used, pages_total=pages_total)
            self.tracer.end(span, **attrs)
        self.tick_count += 1
        if self.journal is not None:
            # one write + fsync for the whole tick's records: a kill loses
            # at most this tick's uncommitted tail, which restore re-derives
            self.journal.commit()
        if self.straggler.record(time.monotonic() - t0):
            self.metrics.on_straggler(tick)
        if self.sentinel is not None:
            self.sentinel.check()
        if self.snapshot_every and \
                self.tick_count % self.snapshot_every == 0:
            self.save_snapshot()

    # -------------------------------------------------------------- phases

    def _pop_next(self, tick: int, can_admit=None):
        """Next request to admit, or None. "fifo" pops the head once it
        has arrived. "spf" picks the shortest ARRIVED prompt, unless a
        request has been passed over ``spf_age_cap`` times: the oldest
        such urgent request goes first. Every non-urgent pick raises the
        skip count of every other arrived request; urgent picks raise
        none. The queue is arrival-sorted, so the arrived set is a
        prefix.

        ``can_admit(req) -> bool`` is the paged admission gate (free pages
        for the prompt). A pick it refuses stays where it is with no side
        effect (no skip counted, no reorder): a page wait blocks the head
        of the line, so FIFO order survives page pressure and the spf skip
        bound is untouched by it."""
        arrived = []
        for i, r in enumerate(self.queue):
            if r.arrival > tick:
                break
            arrived.append((i, r))
        if not arrived:
            return None
        if self.schedule == "fifo":
            idx, req = arrived[0]
        else:
            urgent = [(i, r) for i, r in arrived
                      if self.skips[r.rid] >= self.spf_age_cap]
            if urgent:
                idx, req = urgent[0]      # oldest urgent arrival
            else:
                idx, req = min(arrived, key=lambda ir: (
                    ir[1].prompt_len, ir[1].arrival, ir[1].rid))
        if can_admit is not None and not can_admit(req):
            return None
        if self.schedule != "fifo" and \
                self.skips[req.rid] < self.spf_age_cap:
            for _, r in arrived:
                if r is not req:
                    self.skips[r.rid] += 1
        del self.queue[idx]
        return req

    def _admit(self, tick: int):
        """QUEUED -> PREFILLING: pop arrived requests into free slots and
        zero the slots' stale cache slices.

        A paged engine admits preempted requests first (FIFO: they are the
        oldest admitted work), then the queue, each gated on free pages
        for its whole (re-)prefill record, not only a free slot. A gate
        miss blocks the head of the line: nothing younger jumps it."""
        if self._has_deadlines:
            self._shed_hopeless_queue(tick)
        mask = np.zeros((self.n_slots,), bool)
        for s, slot in enumerate(self.slots):
            if slot.state is not SlotState.FREE:
                continue
            if self.preempted:
                ent = self.preempted[0]
                emitted = self.outputs.get(ent.rid, [])
                record = (np.concatenate([ent.durable,
                                          np.asarray(emitted, np.int32)])
                          if emitted else ent.durable)
                need = self.page_alloc.pages_for(len(record))
                if need > self.page_alloc.free_pages:
                    self.metrics.on_alloc_failure()
                    break                 # head of the line: wait for pages
                self.preempted.popleft()
                self.page_alloc.grow(s, need)
                self.slots[s] = _Slot(
                    state=SlotState.PREFILLING, rid=ent.rid, prompt=record,
                    durable=ent.durable, gen_len=ent.gen_len,
                    deadline=ent.deadline, fault_count=ent.fault_count,
                    replay=bool(emitted), admit_seq=self._admit_seq)
                self._admit_seq += 1
                mask[s] = True
                self.metrics.on_admit(ent.rid, tick, skips=0)
                if self.journal is not None:
                    self.journal.append("admit", tick, rid=int(ent.rid),
                                        slot=s, skips=0)
                if self.tracer is not None:
                    self.tracer.event("admit", tick, rid=ent.rid, slot=s,
                                      wait=0, skips=0, resumed=True)
                iv = SlotInterval(slot=s, rid=ent.rid, admit_tick=tick)
                self.slot_log.append(iv)
                self._open_interval[s] = iv
                continue
            can_admit = None
            if self.paged:
                def can_admit(r):
                    if self.page_alloc.pages_for(r.prompt_len) > \
                            self.page_alloc.free_pages:
                        self.metrics.on_alloc_failure()
                        return False
                    return True
            req = self._pop_next(tick, can_admit)
            if req is None:
                break
            prompt = np.asarray(req.prompt, np.int32)
            self.slots[s] = _Slot(state=SlotState.PREFILLING, rid=req.rid,
                                  prompt=prompt, durable=prompt,
                                  gen_len=req.gen_len, deadline=req.deadline,
                                  admit_seq=self._admit_seq)
            self._admit_seq += 1
            if self.paged:
                self.page_alloc.grow(s, self.page_alloc.pages_for(len(prompt)))
            mask[s] = True
            self.outputs[req.rid] = []
            skips = self.skips.pop(req.rid, 0)
            self.metrics.on_admit(req.rid, tick, skips=skips)
            if self.journal is not None:
                self.journal.append("admit", tick, rid=int(req.rid), slot=s,
                                    skips=skips)
            if self.tracer is not None:
                self.tracer.event("admit", tick, rid=req.rid, slot=s,
                                  wait=tick - req.arrival, skips=skips)
            iv = SlotInterval(slot=s, rid=req.rid, admit_tick=tick)
            self.slot_log.append(iv)
            self._open_interval[s] = iv
        if mask.any():
            self.cache = self._reset_call(mask)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------- page pressure

    def _ptab(self) -> torch.Tensor:
        """The allocator's page table on the device, copied again only when
        the allocator changed (its version): the step operand."""
        if self._ptab_version != self.page_alloc.version:
            self._ptab_cached = self._tensor(self.page_alloc.table())
            self._ptab_version = self.page_alloc.version
        return self._ptab_cached

    def _paged_args(self):
        return (self._ptab(),) if self.paged else ()

    def _reset_call(self, mask: np.ndarray):
        return self._reset(self.cache, self._tensor(mask), *self._paged_args())

    def _slot_pages_needed(self, s: int) -> int:
        """Pages slot ``s`` must own before this tick's device calls: a
        prefilling slot writes up to its next chunk's end, a decoding slot
        one token at position len(durable) + len(outputs) - 1."""
        slot = self.slots[s]
        if slot.state is SlotState.PREFILLING:
            step = (self.prefill_chunk if self.prefill_mode == "chunked"
                    else 1)
            tokens = min(slot.cursor + step, len(slot.prompt))
            if self.prefill_mode == "chunked" and \
                    tokens == len(slot.prompt):
                # the chunk that ends the prompt turns the slot DECODING in
                # this tick, and that first decode writes one position past
                tokens += 1
        else:                              # DECODING
            tokens = len(slot.durable) + len(self.outputs[slot.rid])
        return self.page_alloc.pages_for(tokens)

    def _page_growth(self, tick: int):
        """Grow each occupied slot to the pages this tick's writes need,
        oldest admission first. Page pressure preempts the youngest
        occupied slot younger than the needer (a needer with none younger
        preempts itself: it never steals from its elders, so the oldest
        admission always runs, and submit() made its whole need fit the
        pool)."""
        order = sorted((s for s in range(self.n_slots)
                        if self.slots[s].state is not SlotState.FREE),
                       key=lambda s: self.slots[s].admit_seq)
        for s in order:
            slot = self.slots[s]
            if slot.state is SlotState.FREE:
                continue                   # preempted earlier in the walk
            need = self._slot_pages_needed(s)
            while not self.page_alloc.grow(s, need):
                self.metrics.on_alloc_failure()
                younger = [v for v in range(self.n_slots)
                           if v != s
                           and self.slots[v].state is not SlotState.FREE
                           and self.slots[v].admit_seq > slot.admit_seq]
                if younger:
                    self._preempt(max(younger,
                                      key=lambda v: self.slots[v].admit_seq),
                                  tick)
                else:
                    self._preempt(s, tick)
                    break

    def _preempt(self, s: int, tick: int):
        """Evict slot ``s`` under page pressure: free its pages, queue it
        on the FIFO re-admission deque and journal a "preempt" record. Its
        emitted tokens stay in ``outputs``; re-admitted, it re-prefills
        durable + outputs, and its stream continues bitwise."""
        slot = self.slots[s]
        rid = slot.rid
        freed = self.page_alloc.release(s)
        self.metrics.on_preempt(rid, tick)
        if self.journal is not None:
            self.journal.append("preempt", tick, rid=int(rid), slot=s)
        if self.tracer is not None:
            self.tracer.event("preempt", tick, rid=rid, slot=s,
                              freed_pages=freed)
        self._close_interval(s, tick)
        self.preempted.append(_Preempted(
            rid=rid, durable=slot.durable, gen_len=slot.gen_len,
            deadline=slot.deadline, fault_count=slot.fault_count))
        self.slots[s] = _Slot()

    def _prefill_phase(self, tick: int) -> int:
        prefilling = {s: slot.prompt for s, slot in enumerate(self.slots)
                      if slot.state is SlotState.PREFILLING}
        if not prefilling:
            return 0
        cursors = {s: self.slots[s].cursor for s in prefilling}
        tokens, n_valid = assemble_chunk(prefilling, cursors, self.n_slots,
                                         self.prefill_chunk)
        replaying = any(self.slots[s].replay for s in prefilling)
        restoring = any(self.slots[s].restore for s in prefilling)
        span = (self.tracer.begin(
                    "call", tick, phase="prefill", kind=self.prefill_kind,
                    arch=self.cfg.name, participants=sorted(prefilling),
                    occupancy=len(prefilling) / self.n_slots,
                    replay=replaying, restore=restoring)
                if self.tracer is not None else None)
        c0 = time.monotonic()
        res = self._device_call("prefill", self.prefill_kind, self._prefill,
                                self.params, self.cache,
                                self._tensor(tokens), self._tensor(n_valid),
                                *self._paged_args())
        if res is None:                   # persistent step failure:
            if span is not None:          # quarantine every participant
                self.tracer.end(span, ok=False)
            for s in prefilling:
                self._quarantine(s, tick, "step_exception")
            return 0
        logits, self.cache = res
        lg = self._host_logits(logits, tick, "prefill")
        dur_s = time.monotonic() - c0
        if span is not None:
            self.tracer.end(span, ok=True)
        self.metrics.on_device_call("prefill", kind=self.prefill_kind,
                                    replay=replaying, restore=restoring,
                                    dur_s=dur_s)
        nxt = lg.argmax(axis=-1)
        for s in prefilling:
            if not np.isfinite(lg[s]).all():
                self._quarantine(s, tick, "nonfinite_logits")
                continue
            slot = self.slots[s]
            slot.cursor += int(n_valid[s])
            self.metrics.on_prefill_step(slot.rid)
            if self.tracer is not None:
                self.tracer.event("prefill", tick, rid=slot.rid, slot=s,
                                  cursor=slot.cursor,
                                  prompt_len=len(slot.prompt),
                                  replay=slot.replay)
            if slot.cursor >= len(slot.prompt):
                # the chunk holding the last prompt token yields the first
                # generated token: TTFT lands here
                self._finish_prefill(s, int(nxt[s]), logits, tick)
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
        span = (self.tracer.begin(
                    "call", tick, phase="decode", kind="decode",
                    arch=self.cfg.name,
                    participants=[s for s in range(self.n_slots)
                                  if active[s]],
                    occupancy=float(active.mean()))
                if self.tracer is not None else None)
        c0 = time.monotonic()
        res = self._device_call("decode", "decode", self._decode,
                                self.params, self.cache,
                                self._tensor(tokens), self._tensor(active),
                                *self._paged_args())
        if res is None:
            if span is not None:
                self.tracer.end(span, ok=False)
            for s in range(self.n_slots):
                if active[s]:
                    self._quarantine(s, tick, "step_exception")
            return 0
        logits, self.cache = res
        lg = self._host_logits(logits, tick, "decode")
        dur_s = time.monotonic() - c0
        if span is not None:
            self.tracer.end(span, ok=True)
        self.metrics.on_device_call("decode", kind="decode", dur_s=dur_s)
        nxt = lg.argmax(axis=-1)
        for s, slot in enumerate(self.slots):
            if not active[s]:
                continue
            if not np.isfinite(lg[s]).all():
                self._quarantine(s, tick, "nonfinite_logits")
                continue
            if slot.state is SlotState.PREFILLING:
                slot.cursor += 1
                self.metrics.on_prefill_step(slot.rid)
                if self.tracer is not None:
                    self.tracer.event("prefill", tick, rid=slot.rid,
                                      slot=s, cursor=slot.cursor,
                                      prompt_len=len(slot.prompt),
                                      replay=slot.replay)
                if slot.cursor >= len(slot.prompt):
                    self._finish_prefill(s, int(nxt[s]), logits, tick)
                continue
            tok = int(nxt[s])
            self.outputs[slot.rid].append(tok)
            slot.pending_token = tok
            self.metrics.on_token(slot.rid)
            if self.journal is not None:
                self.journal.append("token", tick, rid=int(slot.rid),
                                    token=tok)
            if len(self.outputs[slot.rid]) >= slot.gen_len:
                self._release(s, tick)
        return 1

    # ----------------------------------------------- fault containment ----

    def _device_call(self, call: str, kind: str, fn, *args):
        """Run a device call under the fault contract: an exception gets
        ``max_step_retries`` re-issues (an injected one is raised before
        the step runs, so the cache is intact for the retry); past the
        budget, returns None and the caller quarantines every slot of the
        call. With no fault plan installed an exception propagates
        unchanged: containment never hides a programming error, or a
        kernel's, in a plain run.

        ``call`` is the fault plan's phase key ("prefill" / "decode");
        ``kind`` the step's call_kind retries are counted under."""
        attempt = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check_step(self.tick_count, call,
                                               attempt)
                return fn(*args)
            except Exception as e:  # noqa: BLE001 — any step failure
                if self.fault_plan is None:
                    raise
                self.metrics.on_fault("step_exception", None,
                                      self.tick_count)
                if self.tracer is not None:
                    self.tracer.event("fault", self.tick_count,
                                      kind="step_exception", call=kind,
                                      attempt=attempt, error=str(e))
                attempt += 1
                if attempt > self.max_step_retries:
                    return None
                self.metrics.on_retry(kind)
                if self.tracer is not None:
                    self.tracer.event("retry", self.tick_count, call=kind,
                                      attempt=attempt)

    def _host_logits(self, logits, tick: int, call: str) -> np.ndarray:
        """Host-side (B, V) f32 logits for argmax and the finite guard; the
        fault plan's nan_logits events poison rows of this copy (the
        corruption a real device would hand back)."""
        lg = logits[:, 0, :].float().cpu().numpy()
        if self.fault_plan is not None:
            bad = self.fault_plan.logit_slots(tick, call)
            if bad:
                lg = corrupt_logits(lg, bad)
        return lg

    def _inject_cache_faults(self, tick: int):
        slots = [s for s in self.fault_plan.cache_slots(tick)
                 if self.slots[s].state is not SlotState.FREE]
        if not slots:
            return
        corrupt_cache(self.cache, slots, self.n_slots)
        for s in slots:
            self.metrics.on_fault("cache_corruption", self.slots[s].rid,
                                  tick)
            if self.tracer is not None:
                self.tracer.event("fault", tick, kind="cache_corruption",
                                  rid=self.slots[s].rid, slot=s)

    def _quarantine(self, s: int, tick: int, kind: str):
        """Contain a fault to slot ``s`` and schedule recovery by replay:
        zero the slot's cache with the compiled reset step and re-prefill
        its durable record (prompt + tokens emitted so far). Past
        ``max_replays`` the request is shed ("fault_budget")."""
        slot = self.slots[s]
        rid = slot.rid
        self.metrics.on_fault(kind, rid, tick)
        slot.fault_count += 1
        if self.tracer is not None:
            self.tracer.event("quarantine", tick, rid=rid, slot=s,
                              kind=kind, fault_count=slot.fault_count)
        if slot.fault_count > self.max_replays:
            self.metrics.on_shed(rid, tick, "fault_budget")
            if self.journal is not None:
                self.journal.append("shed", tick, rid=int(rid),
                                    reason="fault_budget")
            if self.tracer is not None:
                self.tracer.event("shed", tick, rid=rid, slot=s,
                                  reason="fault_budget")
            self._close_interval(s, tick)
            if self.paged:
                self.page_alloc.release(s)
            self.slots[s] = _Slot()
            return
        self.metrics.on_replay(rid)
        emitted = self.outputs[rid]
        record = (np.concatenate([slot.durable,
                                  np.asarray(emitted, np.int32)])
                  if emitted else slot.durable)
        slot.prompt = record
        slot.cursor = 0
        slot.pending_token = 0
        slot.replay = bool(emitted)
        slot.restore = False              # a fault replay, not restart work
        slot.state = SlotState.PREFILLING
        if self.tracer is not None:
            self.tracer.event("replay", tick, rid=rid, slot=s,
                              record_len=int(len(record)))
        mask = np.zeros((self.n_slots,), bool)
        mask[s] = True
        self.cache = self._reset_call(mask)

    # ------------------------------------------------------ SLO shedding --

    def _min_ticks_to_done(self, prompt_left: int, gen_left: int,
                           queued: bool = False) -> int:
        """OPTIMISTIC ticks (the current one included) until the request
        finishes: the last prefill chunk emits the first of the remaining
        tokens, then one token a tick. A lower bound, so a request is shed
        only when its deadline is provably out of reach.

        ``queued=True`` on a paged engine adds the page-wait floor: when
        the free pool cannot hold the prompt's pages, admission cannot
        happen this tick, so at least one more passes (exactly one keeps
        the bound: one release could free all it needs)."""
        est = (((math.ceil(prompt_left / self.prefill_chunk)
                 if self.prefill_mode == "chunked" else prompt_left)
                + max(gen_left - 1, 0))
               if prompt_left > 0 else max(gen_left, 1))
        if queued and self.paged and \
                self.page_alloc.pages_for(prompt_left) > \
                self.page_alloc.free_pages:
            est += 1
        return est

    def _shed_hopeless_queue(self, tick: int):
        """Drop arrived queued requests whose deadline is out of reach even
        if admitted now, before they take a slot."""
        kept = []
        while self.queue and self.queue[0].arrival <= tick:
            r = self.queue.popleft()
            est = self._min_ticks_to_done(r.prompt_len, r.gen_len,
                                          queued=True)
            if r.deadline is not None and tick + est - 1 > r.deadline:
                self.skips.pop(r.rid, None)
                self.metrics.on_shed(r.rid, tick, "deadline")
                if self.journal is not None:
                    self.journal.append("shed", tick, rid=int(r.rid),
                                        reason="deadline")
                if self.tracer is not None:
                    self.tracer.event("shed", tick, rid=r.rid,
                                      reason="deadline", where="queue")
            else:
                kept.append(r)
        self.queue.extendleft(reversed(kept))

    def _shed_hopeless_slots(self, tick: int):
        """Free the slot of an in-flight request the tick its deadline
        becomes unreachable."""
        for s, slot in enumerate(self.slots):
            if slot.state is SlotState.FREE or slot.deadline is None:
                continue
            gen_left = slot.gen_len - len(self.outputs[slot.rid])
            prompt_left = (len(slot.prompt) - slot.cursor
                           if slot.state is SlotState.PREFILLING else 0)
            if tick + self._min_ticks_to_done(prompt_left, gen_left) - 1 \
                    > slot.deadline:
                self.metrics.on_shed(slot.rid, tick, "deadline")
                if self.journal is not None:
                    self.journal.append("shed", tick, rid=int(slot.rid),
                                        reason="deadline")
                if self.tracer is not None:
                    self.tracer.event("shed", tick, rid=slot.rid, slot=s,
                                      reason="deadline", where="slot")
                self._close_interval(s, tick)
                if self.paged:
                    self.page_alloc.release(s)
                self.slots[s] = _Slot()   # cache zeroed at next admit

    # ------------------------------------------------------------- helpers

    def _finish_prefill(self, s: int, token: int, logits: torch.Tensor,
                        tick: int):
        """The chunk or step that took the last token of slot ``s``'s
        prefill record: its argmax ``token`` is the next generated token;
        ``logits`` are the call's (B, 1, V) logits."""
        slot = self.slots[s]
        slot.state = SlotState.DECODING
        slot.pending_token = token
        self.outputs[slot.rid].append(token)
        if not slot.replay:
            # a replayed record's last chunk yields the next token of a
            # started stream: first_logits and TTFT were recorded before
            self.first_logits[slot.rid] = logits[s].to("cpu", copy=True)
            self.metrics.on_first_token(slot.rid, tick)
            if self.tracer is not None:
                self.tracer.event("first_token", tick, rid=slot.rid, slot=s)
        slot.replay = False
        slot.restore = False
        self.metrics.on_token(slot.rid)
        if self.journal is not None:
            self.journal.append("token", tick, rid=int(slot.rid),
                                token=int(token))
        if len(self.outputs[slot.rid]) >= slot.gen_len:
            self._release(s, tick)

    def _close_interval(self, s: int, tick: int):
        iv = self._open_interval.pop(s, None)
        if iv is not None:
            iv.release_tick = tick + 1
            if self.tracer is not None:
                self.tracer.interval(iv.slot, iv.rid, iv.admit_tick,
                                     iv.release_tick)

    def _release(self, s: int, tick: int):
        slot = self.slots[s]
        self.metrics.on_done(slot.rid, tick)
        if self.journal is not None:
            self.journal.append("done", tick, rid=int(slot.rid))
        if self.tracer is not None:
            self.tracer.event("release", tick, rid=slot.rid, slot=s,
                              tokens=len(self.outputs[slot.rid]))
        self._close_interval(s, tick)
        if self.paged:
            self.page_alloc.release(s)
        self.slots[s] = _Slot()           # FREE; cache zeroed at next admit
